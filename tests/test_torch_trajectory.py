"""PyTorch port vs the JAX package: the trajectory machine of every mode
(plain twins on the CPU; the CUDA kernel runs the same machine and is held
to these twins by chip_smoke.py on the card).

Float64, JAX op by op (``test_torch_integrators.eager_jit``), held as
``test_torch_integrators.compare_f64`` holds the tick: the discrete fields
(``mode``, ``started``, ``complete``, ``manual_mode``, ``manual_init``,
``is_landed``, ``init_b1d``), the parameters and the machine's clock,
planned duration, settle rate and yaw rate bitwise; the fields XLA's and
torch's float64 ``atan2``, ``sin``, ``cos`` and ``exp`` reach (the reset
pose and what the dynamics carry of it, the goal, the heading) within
``TRANSCENDENTAL_ULPS`` ulps of their largest magnitude (or of 1).  JAX's hover
draws are rebuilt from its machine keys (``test_torch_env._machine_draws``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import train as jtrain
from gym_rotor_tpu.envs import batch as jbatch
from gym_rotor_tpu.envs import trajectory as jtraj
from gym_rotor_tpu.models import zoo as jmodels
from gym_rotor_tpu.envs.quad import DT
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch.convert import (actor_params_from_jax,
                                         env_state_from_numpy)
from gym_rotor_tpu_torch.envs import batch as tbatch
from gym_rotor_tpu_torch.envs import trajectory as ttraj
from gym_rotor_tpu_torch.envs.draws import TrajDraws
from gym_rotor_tpu_torch.evaluate import evaluate
from gym_rotor_tpu_torch.models.emlp import zoo as tzoo
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from test_torch_env import _machine_draws, _t, _tick_draws
from test_torch_integrators import (EXACT_FIELDS, TRANSCENDENTAL_ULPS,
                                    compare_f64, compare_out, eager_jit)
from torch_jax_fixtures import jax_rho_memo  # noqa: F401

torch.set_num_threads(1)

_GOAL = ("xd", "vd", "b1d", "b1d_dot", "Wd")
# mode -> (framework, integrator): every mode on both tasks' code paths and
# all three integrators over the eight cases
MODE_CASES = {0: ("MODUL", "rk4"), 1: ("MONO", "euler"),
              2: ("MODUL", "dop853"), 3: ("MONO", "rk4"),
              4: ("MODUL", "euler"), 5: ("MONO", "dop853"),
              6: ("MODUL", "rk4"), 7: ("MONO", "euler")}
N = 8


def _np(t):
    return t.detach().cpu().numpy()


@functools.lru_cache(maxsize=None)
def _cfgs(mode, framework, integrator, max_steps):
    kw = dict(num_envs=N, max_steps=max_steps, framework=framework,
              integrator=integrator, train_traj_mode=mode)
    return JConfig(**kw), TConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    """The JAX tick of ``jcfg`` compiled op by op for N float64 envs."""
    jbs, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(0), "train",
                                  jnp.float64)
    a = jnp.zeros((N, sum(jcfg.action_dim_n)))
    return eager_jit(lambda b, a: jbatch.batched_step(jcfg, b, a), jbs, a)


_draws = jax.jit(lambda b: _tick_draws(b, jnp.float64))


def _port(jbs):
    tree = jax.tree.map(np.asarray, serialization.to_state_dict(jbs))
    return env_state_from_numpy(tree, device="cpu")


def _run(jcfg, tcfg, jbs, actions, ticks, what):
    """``ticks`` lockstep ticks of JAX and of the port from ``jbs`` (the
    port from its converted copy), compared after each; returns both
    final states and the number of resets."""
    tbs = _port(jbs)
    step = _jax_step(jcfg)
    resets = 0
    for k in range(ticks):
        a = actions(k)
        dr = _t(_draws(jbs))
        jbs, jout = step(jbs, jnp.asarray(a))
        tbs, tout = tbatch.batched_step(tcfg, tbs, _t(a), dr)
        compare_f64(tbs, jbs, f"{what} tick {k}")
        compare_out(jcfg, tout, jout, f"{what} tick {k}")
        resets += int(np.asarray(jout.reset_happened).sum())
    return jbs, tbs, resets


def _random_actions(jcfg, seed):
    rng = np.random.default_rng(seed)
    adim = sum(jcfg.action_dim_n)

    def actions(_):
        a = rng.normal(0.0, 0.3, size=(N, adim))
        a[:, 0] = rng.uniform(-0.3, 0.1, N)
        return a
    return actions


@pytest.mark.parametrize("mode", sorted(MODE_CASES))
def test_static_mode_f64(mode):
    """30 ticks in ``train_traj_mode`` ``mode`` (7: the clamp to the
    eight), caps at 10 ticks so every env crosses auto-resets: the current
    machine and the fresh machine of each reset, with JAX's draws."""
    jcfg, tcfg = _cfgs(mode, *MODE_CASES[mode], 10)
    jbs, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(40 + mode),
                                  "train", jnp.float64)
    jbs, tbs, resets = _run(jcfg, tcfg, jbs, _random_actions(jcfg, mode), 30,
                            f"mode {mode}")
    assert resets >= 2 * N
    assert (_np(tbs.traj.mode) == mode).all()
    if mode == 1:                      # the hover draws were taken
        assert (_np(tbs.traj.t_traj) >= 2.0).all()


def _hover_actions(jbs, jcfg):
    """The exact hover thrust for each env's parameters, zero moments."""
    p = jbs.env.params
    a0 = np.asarray((p.m * 9.81 / 4.0 - p.avrg_act) / p.scale_act)
    a = np.zeros((N, sum(jcfg.action_dim_n)))
    a[:, 0] = a0
    return lambda _: a


@pytest.mark.parametrize("mode", [2, 4, 5, 6])
def test_manual_hold_entry(mode):
    """Entry into the manual hold.  Mode 4 holds from its first tick.
    Modes 2, 5 and 6 end after 10 s, 33 s and 27 s, so the JAX machines
    start three ticks short of their planned end (``t``, carried over by
    the converter with ``started``, ``center`` and the rest), at rest at
    their targets (mode 2 holds only once its target is reached), under the
    hover thrust: the tick past ``t_traj`` switches to the hold, which
    freezes Wd and keeps t."""
    jcfg, tcfg = _cfgs(mode, *MODE_CASES[mode], 10)     # 9 ticks: no cap
    jbs, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(50 + mode),
                                  "train", jnp.float64)
    if mode != 4:
        tr = jbs.traj
        # at rest at the target the climb ends at (mode 2's reached test)
        x = tr.xd.at[:, 2].set(jtraj.TAKEOFF_END_HEIGHT) if mode == 2 \
            else tr.xd
        jbs = jbs.replace(
            env=jbs.env.replace(x=x, v=jnp.zeros_like(tr.vd),
                                W=jnp.zeros_like(jbs.env.W)),
            traj=tr.replace(t=tr.t_traj - 3 * DT))
    assert not np.asarray(jbs.traj.manual_mode).any() or mode == 4
    jbs, tbs, resets = _run(jcfg, tcfg, jbs, _hover_actions(jbs, jcfg), 8,
                            f"mode {mode} hold")
    assert resets == 0
    held = _np(tbs.traj.manual_mode)
    assert held.all() and _np(tbs.traj.manual_init).all()
    assert (_np(tbs.traj.complete) == held).all()
    # in the hold t stops and the velocity target is zero
    jbs2, tbs2, _ = _run(jcfg, tcfg, jbs, _hover_actions(jbs, jcfg), 1,
                         f"mode {mode} held")
    np.testing.assert_array_equal(_np(tbs2.traj.t), _np(tbs.traj.t))
    np.testing.assert_array_equal(_np(tbs2.traj.Wd), _np(tbs.traj.Wd))
    assert (_np(tbs2.env.goal.vd) == 0.0).all()


def test_runtime_mode_path_f64():
    """The runtime-mode ``get_desired`` (a traced mode in JAX, a tensor in
    the port) through a schedule of per-env modes with changes mid-stream:
    a change restarts the machine, every branch is computed and the
    clamped mode's selected, the manual overlay covers every mode."""
    n = N
    jcfg = JConfig(num_envs=n)
    jbs, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(60), "train",
                                  jnp.float64)
    env = jbs.env
    jts = jbs.traj
    rng = np.random.default_rng(61)
    schedule = ([[0] * n] * 2 + [[1] * n] * 2 + [[4] * n] * 3
                + [[2, 3, 4, 5, 6, 7, -1, 1]] * 3 + [[6] * n] * 2
                + [[1, 0, 9, 4, 4, 2, 5, 3]] * 2)

    def one(ts, x, v, R, W, m):
        return jtraj.get_desired(ts, x, v, R, W, m)
    args = (jts, env.x, env.v, env.R, env.W, jnp.zeros(n, jnp.int32))
    jget = eager_jit(jax.vmap(one), *args)
    mdraws = jax.jit(jax.vmap(lambda k: _machine_draws(k, jnp.float64)))
    tts = _port(jbs).traj
    x, v, R, W = (np.asarray(a) for a in (env.x, env.v, env.R, env.W))
    for k, modes in enumerate(schedule):
        u = _t(mdraws(jts.key))
        m = np.asarray(modes, np.int32)
        jts, jgoal = jget(jts, jnp.asarray(x), jnp.asarray(v), jnp.asarray(R),
                          jnp.asarray(W), jnp.asarray(m))
        tts, tgoal = ttraj.get_desired(tts, _t(x), _t(v), _t(R), _t(W),
                                       torch.from_numpy(m),
                                       TrajDraws(u[:, 0], u[:, 1], u[:, 2]))
        jt = jax.tree.map(np.asarray, serialization.to_state_dict(jts))
        for name in jt:
            if name == "key":
                continue
            got, ref = _np(getattr(tts, name)), jt[name]
            if ref.dtype.kind == "f" and f"traj.{name}" not in EXACT_FIELDS:
                scale = max(float(np.max(np.abs(ref))), 1.0)
                assert np.max(np.abs(got - ref)) <= \
                    TRANSCENDENTAL_ULPS * np.spacing(scale), (k, name)
            else:
                np.testing.assert_array_equal(got, ref, err_msg=f"{k} {name}")
        for name in _GOAL:
            ref = np.asarray(getattr(jgoal, name))
            scale = max(float(np.max(np.abs(ref))), 1.0)
            assert np.max(np.abs(_np(getattr(tgoal, name)) - ref)) <= \
                TRANSCENDENTAL_ULPS * np.spacing(scale), (k, name)
        # the envs move on (the machine reads the pose, not the physics)
        x = x + 0.01 * rng.normal(size=x.shape)
        v = v + 0.05 * rng.normal(size=v.shape)
    final = _np(tts.mode)
    np.testing.assert_array_equal(final, schedule[-1])
    assert _np(tts.manual_mode)[final == 4].all()


def test_evaluate_honours_traj_mode():
    """``evaluate`` runs the eval envs in ``cfg.train_traj_mode``, as
    ``train.build_eval_rollout`` does through ``batched_step``: seeded TD3
    EMLP actors, the figure-eight (mode 6) with Euler, 10 eval envs x 200
    ticks from the same initial states, float32; tolerances as
    ``test_torch_evaluate.py``'s."""
    kw = dict(eval_max_steps=1, train_traj_mode=6, integrator="euler")
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    params, actors = [], []
    for i in range(jcfg.n_agents):
        adef = jmodels.td3_models(jcfg, i).actor_def
        params.append(adef.init(jax.random.PRNGKey(70 + i),
                                jnp.zeros((1, jcfg.obs_dim_n[i]),
                                          jnp.float32)))
        rin, hid, rout = tzoo.actor_reps(tcfg, "MODUL", i)
        actor = tzoo.EMLPActorDet(rin, hid, rout, device="cpu")
        actor.load_state_dict(actor_params_from_jax(
            jax.tree.map(np.asarray, params[-1]), tcfg, i))
        actors.append((adef, actor))

    def act_eval(states, obs):
        return jnp.concatenate([m.apply(p, o) for (m, _), p, o
                                in zip(actors, params, obs)], axis=-1)
    key = jax.random.PRNGKey(1992)
    ep_j, bench_j, succ_j, ex_j, eb1_j, _ = jtrain.build_eval_rollout(
        jcfg, act_eval)(None, key)
    jbs, jobs = jbatch.batched_reset(jcfg.replace(num_envs=jcfg.num_eval),
                                     key, "eval")
    assert (np.asarray(jbs.traj.mode) == 6).all()
    ep_t, bench_t, succ_t, ex_t, eb1_t, _ = evaluate(
        tcfg, [a for _, a in actors], generator=torch.Generator().manual_seed(0),
        device="cpu", init=(_port(jbs), tuple(_t(o) for o in jobs)))
    np.testing.assert_allclose(ep_t.numpy(), np.asarray(ep_j), rtol=1e-5)
    np.testing.assert_allclose(float(bench_t), float(bench_j), rtol=1e-5)
    np.testing.assert_array_equal(succ_t.numpy(), np.asarray(succ_j))
    np.testing.assert_allclose(ex_t.numpy(), np.asarray(ex_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(eb1_t), float(eb1_j), rtol=0, atol=1e-5)
