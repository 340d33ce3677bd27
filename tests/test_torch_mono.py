"""PyTorch port vs the JAX package: the MONO framework (the ``coupled``
task, one agent with 23 obs and 4 actions) on the plain twins of K1 (env
tick), K3/K4 (EMLP blocks), K3-actor, K6, K7 and K2/K8.  The CUDA kernels,
the coupled instance of K1 and the MONO instances of K3-actor and K3/K4
among them, are held to the same twins by chip_smoke.py on the card.

Tolerances, as for MODUL (``test_torch_env.py``, ``test_torch_td3.py``):
the float64 step is bitwise to JAX eager where no transcendental enters
(the eb1 heading error goes through ``atan2``: a few ulp); the jitted
float64 rollout agrees to 1e-10 with rewards within four float32 ulp of
the raw reward (XLA contracts the float32 reward chain); networks within
1e-12 (forward) and 1e-9 (gradients); the float32 superstep within the
bounds of ``test_torch_td3.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gym_rotor_tpu.envs import batch as jbatch
from gym_rotor_tpu.envs import quad as jquad
from gym_rotor_tpu.models.emlp import zoo as jzoo
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch import convert, evaluate as tevaluate
from gym_rotor_tpu_torch.algos import td3 as ttd3
from gym_rotor_tpu_torch.envs import batch as tbatch
from gym_rotor_tpu_torch.envs import quad as tquad
from gym_rotor_tpu_torch.kernels import emlp_actor as kactor
from gym_rotor_tpu_torch.kernels import emlp_block as kblock
from gym_rotor_tpu_torch.kernels import env_tick as ktick
from gym_rotor_tpu_torch.models.emlp import zoo as tzoo
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from test_torch_env import (_compare_state, _port_state, _reset_draws,
                            _tick_draws)
from test_torch_td3 import _close, _cfgs, _np_tree, _to64, superstep_vs_jax

torch.set_num_threads(1)
MONO = dict(framework="MONO")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _actions(rng, n):
    """Near-hover thrust and moments (the MONO action is the moment
    itself) with enough spread that some envs crash."""
    a = rng.normal(0.0, 0.2, size=(n, 4))
    a[:, 0] = rng.uniform(-0.4, 0.1, n)
    return a


# four float32 ulp of the raw reward (|r| <= |reward_min| = 14), mapped
# through the interpolation slope 1/14
_RMIN = abs(JConfig(**MONO).reward_min)
_REWARD_ULP4 = 4 * float(np.spacing(np.float32(_RMIN))) / _RMIN


# ---------------------------------------------------------------------------
# the coupled task
# ---------------------------------------------------------------------------
def test_step_coupled_bitwise_f64():
    """``quad.step`` of the coupled task from JAX-reset states, eager
    float64 JAX: the dynamics (x, v, R, W, the wrench), the position
    integrals and every obs column but the heading terms bitwise; the
    heading error's ``atan2`` and what it feeds within a few ulp; reward,
    done and info equal."""
    n = 32
    jcfg, tcfg = JConfig(num_envs=n, **MONO), TConfig(num_envs=n, **MONO)
    jbs, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(2), "train",
                                  jnp.float64)
    tenv = _port_state(jbs, torch.float64).env
    a = _actions(np.random.default_rng(1), n)
    with jax.disable_jit():
        jenv, jout = jax.vmap(lambda s, x: jquad.step(jcfg, s, x))(
            jbs.env, jnp.asarray(a))
    tenv, tout = tquad.step(tcfg, tenv, _t(a))
    for name in ("x", "v", "R", "W", "eIx", "eIx_integrand", "f_total", "M"):
        np.testing.assert_array_equal(_np(getattr(tenv, name)),
                                      np.asarray(getattr(jenv, name)), name)
    for name in ("eIb1", "eIb1_integrand"):
        np.testing.assert_allclose(_np(getattr(tenv, name)),
                                   np.asarray(getattr(jenv, name)),
                                   rtol=1e-13, atol=1e-15, err_msg=name)
    assert len(tout.obs) == 1 and tout.obs[0].shape == (n, 23)
    got, ref = _np(tout.obs[0]), np.asarray(jout.obs)
    exact = np.r_[0:18, 20:23]
    np.testing.assert_array_equal(got[:, exact], ref[:, exact])
    np.testing.assert_allclose(got[:, 18:20], ref[:, 18:20], rtol=0,
                               atol=2 * np.spacing(np.float32(1)))
    np.testing.assert_array_equal(_np(tout.reward), np.asarray(jout.reward))
    np.testing.assert_array_equal(_np(tout.done), np.asarray(jout.done))
    np.testing.assert_array_equal(_np(tout.info["ex"]),
                                  np.asarray(jout.info["ex"]))
    assert tout.reward.shape == tout.done.shape == (n, 1)


@pytest.mark.parametrize("env_type", ["train", "eval"])
def test_reset_coupled_matches_jax_f64(env_type):
    jcfg, tcfg = JConfig(num_envs=64, **MONO), TConfig(num_envs=64, **MONO)
    key = jax.random.PRNGKey(8)
    jbs, jobs = jbatch.batched_reset(jcfg, key, env_type, jnp.float64)
    draws = _t(_reset_draws(key, 64, jnp.float64))
    tbs, tobs = tbatch.batched_reset(tcfg, None, env_type, torch.float64,
                                     device="cpu", draws=draws)
    _compare_state(tbs, jbs, rtol=1e-13, atol=1e-14, what=f"reset {env_type}")
    assert len(jobs) == len(tobs) == 1
    np.testing.assert_allclose(_np(tobs[0]), np.asarray(jobs[0]), rtol=1e-6,
                               atol=1e-7)


def test_batched_step_coupled_rollout_f64():
    """200 ticks, 64 MONO envs, max_steps lowered so caps and crash resets
    both happen, the port on its own from the converted initial state with
    JAX's draws: state within 1e-10, flags equal, rewards within four
    float32 ulp of the raw reward, obs and terminal obs within 1e-6."""
    n, ticks = 64, 200
    jcfg = JConfig(num_envs=n, max_steps=60, **MONO)
    tcfg = TConfig(num_envs=n, max_steps=60, **MONO)
    jbs, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(3), "train",
                                  jnp.float64)
    tbs = _port_state(jbs, torch.float64)
    jstep = jax.jit(lambda b, a: jbatch.batched_step(jcfg, b, a))
    jdraws = jax.jit(lambda b: _tick_draws(b, jnp.float64))
    rng = np.random.default_rng(5)
    resets = caps = 0
    worst = 0.0
    for k in range(ticks):
        a = _actions(rng, n)
        draws = _t(jdraws(jbs))
        jbs, jout = jstep(jbs, jnp.asarray(a))
        tbs, tout = tbatch.batched_step(tcfg, tbs, _t(a), draws)
        worst = max(worst, _compare_state(tbs, jbs, rtol=1e-10, atol=1e-10,
                                          what=f"tick {k}"))
        for name in ("done", "reset_happened"):
            np.testing.assert_array_equal(_np(getattr(tout, name)),
                                          np.asarray(getattr(jout, name)))
        np.testing.assert_array_equal(_np(tout.info["crashed"]),
                                      np.asarray(jout.info["crashed"]))
        diff = np.abs(_np(tout.reward) - np.asarray(jout.reward))
        assert np.all(diff <= _REWARD_ULP4), (k, diff.max())
        for ref, got in zip(jout.obs + jout.info["terminal_obs"],
                            tout.obs + tout.info["terminal_obs"]):
            np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6,
                                       atol=1e-6)
        reset = np.asarray(jout.reset_happened)
        resets += int(reset.sum())
        caps += int((reset & ~np.asarray(jout.info["crashed"])[:, 0]).sum())
    assert resets > 20 and caps > 20, (resets, caps)
    assert worst < 1e-10


def test_batched_step_coupled_eager_f64():
    """Eager float64 JAX ticks: a step and a capped step with its fresh
    episode, bitwise up to the math library's transcendentals."""
    n = 8
    jcfg = JConfig(num_envs=n, max_steps=2, **MONO)
    tcfg = TConfig(num_envs=n, max_steps=2, **MONO)
    jbs, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(11), "train",
                                  jnp.float64)
    tbs = _port_state(jbs, torch.float64)
    rng = np.random.default_rng(2)
    for k in range(2):
        a = _actions(rng, n)
        draws = _t(_tick_draws(jbs, jnp.float64))
        with jax.disable_jit():
            jbs, jout = jbatch.batched_step(jcfg, jbs, jnp.asarray(a))
        tbs, tout = tbatch.batched_step(tcfg, tbs, _t(a), draws)
        _compare_state(tbs, jbs, rtol=1e-13, atol=1e-14, what=f"eager {k}")
        np.testing.assert_array_equal(_np(tout.reset_happened),
                                      np.asarray(jout.reset_happened))
        np.testing.assert_array_equal(_np(tout.done), np.asarray(jout.done))
        np.testing.assert_array_equal(_np(tout.reward), np.asarray(jout.reward))
    assert bool(tout.reset_happened.all())      # every env hit the cap


@pytest.mark.parametrize("framework", ["MODUL", "MONO"])
def test_tick_output_layout_matches_plain_twin(framework):
    """The kernel's output slots (``env_tick.OUT``, generated into its
    header) have the widths of the plain twin's outputs for each task."""
    cfg = TConfig(num_envs=3, framework=framework)
    task = ktick.task_of(cfg)
    gen = torch.Generator().manual_seed(0)
    bs, obs = tbatch.batched_reset(cfg, gen, device="cpu")
    a = torch.zeros(3, sum(cfg.action_dim_n))
    _, out = ktick.env_tick_plain(cfg, bs, a, torch.rand(
        3, tbatch.D.N_DRAWS, generator=gen))
    n = cfg.n_agents
    want = {f"obs{i + 1}": o.shape[1] for i, o in enumerate(out.obs)}
    want.update({f"term_obs{i + 1}": o.shape[1]
                 for i, o in enumerate(out.info["terminal_obs"])})
    want.update(reward=n, ex=3, eb1=1)
    assert dict(ktick.OUT[task]["F"]) == want
    assert dict(ktick.OUT[task]["B"]) == dict(done=n, reset=1, crashed=n)
    assert out.reward.shape == out.done.shape == out.info["crashed"].shape \
        == (3, n)
    header = ktick.layout_header()["env_tick_layout.h"]
    assert f"#define OF_{task.upper()}_REWARD" in header
    assert f"#define NB_OUT_{task.upper()} {2 * n + 1}" in header
    for integrator in ("euler", "dop853"):       # K1 has instances for these
        assert ktick.task_of(cfg.replace(integrator=integrator,
                                         train_traj_mode=5,
                                         exact_so3=True)) == task
    with pytest.raises(NotImplementedError):      # no instance covers it
        ktick.task_of(cfg.replace(integrator="rk45"))


# ---------------------------------------------------------------------------
# MONO EMLP networks
# ---------------------------------------------------------------------------
def test_mono_kernel_instances_cover_full_width():
    """At the flagship's widths (actor 16, critics 62) the MONO actor is a
    K3-actor instance of the deterministic head, every MONO block a K3/K4
    instance; the actor's rep_in is 23 wide and the critic's 27."""
    cfg = TConfig(**MONO)
    agent = ttd3.TD3Agent(cfg, 0, "cpu")
    assert kactor.actor_dims(agent.actor_net) == (23, 18, 16, 4)
    assert (23, 18, 16, 4) in kactor.INSTANCES[kactor.HEAD_TANH]
    dims = [kblock.block_spec(b, "cpu").dims for _, b in
            agent.actor_net.named_blocks()
            + agent.critic_net.network1.named_blocks()
            + agent.critic_net.network2.named_blocks()]
    assert dims == [(23, 18, 16), (16, 18, 16)] + [(27, 71, 62),
                                                   (62, 71, 62)] * 2
    assert set(dims) <= kblock.INSTANCES


def test_mono_actor_matches_flax():
    """``EMLPActorDet`` of the MONO reps (23 in, SO2eR3 hidden, scalar +
    T3 out) loaded with ``actor_params_from_jax`` vs flax, float64."""
    jcfg, tcfg = _cfgs(**MONO)
    mod = jzoo.EMLPActorDet(*jzoo.actor_reps(jcfg, "MONO", 0))
    params = _to64(mod.init(jax.random.PRNGKey(4), jnp.zeros((1, 23))))
    obs = np.random.default_rng(3).normal(0, 0.5, (24, 23))
    ref = np.asarray(mod.apply(params, jnp.asarray(obs)))
    actor = tzoo.EMLPActorDet(*tzoo.actor_reps(tcfg, "MONO", 0), device="cpu",
                              dtype=torch.float64)
    actor.load_state_dict(convert.actor_params_from_jax(_np_tree(params),
                                                        tcfg, 0))
    with torch.no_grad():
        _close(_np(actor(_t(obs))), ref, 1e-12, "actor")
    agent = ttd3.TD3Agent(tcfg, 0, "cpu", torch.float64)
    flat = convert.flat_from_jax(_np_tree(params), agent.actor_layout, "cpu",
                                 torch.float64)
    _close(_np(agent.actor_apply(agent.actor_layout.views(flat), _t(obs))),
           ref, 1e-12, "training path")


def test_mono_twin_critic_matches_flax():
    """The MONO twin critic on the training path (projection once, the
    block function per block) vs flax's ``EMLPCriticTwin``: both Qs and the
    gradients with respect to the flat parameters, obs and actions,
    float64; the structured critic through ``critic_params_from_jax``."""
    jcfg, tcfg = _cfgs(**MONO)
    mod = jzoo.EMLPCriticTwin(*jzoo.critic_reps(jcfg, "MONO", 0, "DTDE"))
    params = _to64(mod.init(jax.random.PRNGKey(6), jnp.zeros((1, 23)),
                            jnp.zeros((1, 4))))
    agent = ttd3.TD3Agent(tcfg, 0, "cpu", torch.float64)
    rng = np.random.default_rng(12)
    obs = rng.normal(0, 0.5, (16, 23))
    act = rng.uniform(-1, 1, (16, 4))
    w1, w2 = rng.normal(size=(2, 16, 1))

    def f(p, o, a):
        q1, q2 = mod.apply(p, o, a)
        return jnp.sum(q1 * w1) + jnp.sum(q2 * w2), (q1, q2)
    (_, (q1, q2)), (gp, go, ga) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(obs),
                                           jnp.asarray(act))
    flat = convert.flat_from_jax(_np_tree(params), agent.critic_layout, "cpu",
                                 torch.float64).requires_grad_(True)
    ot, at = _t(obs).requires_grad_(True), _t(act).requires_grad_(True)
    tq1, tq2 = agent.critic_apply(agent.critic_layout.views(flat), ot, at)
    ((tq1 * _t(w1)).sum() + (tq2 * _t(w2)).sum()).backward()
    _close(_np(tq1), q1, 1e-9, "q1")
    _close(_np(tq2), q2, 1e-9, "q2")
    _close(_np(flat.grad), ravel_pytree(gp)[0], 1e-9, "grad params")
    _close(_np(ot.grad), go, 1e-9, "grad obs")
    _close(_np(at.grad), ga, 1e-9, "grad act")
    critic = tzoo.EMLPCriticTwin(*tzoo.critic_reps(tcfg, "MONO", 0, "DTDE"),
                                 device="cpu", dtype=torch.float64)
    critic.load_state_dict(convert.critic_params_from_jax(_np_tree(params),
                                                          tcfg, 0))
    with torch.no_grad():
        _close(_np(critic.q1(_t(obs), _t(act))), q1, 1e-12, "structured q1")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def test_evaluate_coupled_matches_build_eval_rollout():
    """``evaluate`` for MONO (10 eval envs x 200 ticks, seeded flax actor)
    vs ``train.build_eval_rollout`` from the same initial states: the
    success column is position only, shape (num_eval, 1)."""
    import train as train_mod
    jcfg = JConfig(eval_max_steps=1, **MONO)
    tcfg = TConfig(eval_max_steps=1, **MONO)
    mod = jzoo.EMLPActorDet(*jzoo.actor_reps(jcfg, "MONO", 0))
    params = mod.init(jax.random.PRNGKey(9), jnp.zeros((1, 23)))

    def act_eval(states, obs):
        return mod.apply(params, obs[0])
    key = jax.random.PRNGKey(1992)
    ep_j, bench_j, succ_j, ex_j, eb1_j, _ = train_mod.build_eval_rollout(
        jcfg, act_eval)(None, key)
    jbs, jobs = jbatch.batched_reset(jcfg.replace(num_envs=jcfg.num_eval), key,
                                     "eval")
    tbs = convert.env_state_from_numpy(_np_tree(jbs), device="cpu")
    actor = tzoo.EMLPActorDet(*tzoo.actor_reps(tcfg, "MONO", 0), device="cpu")
    actor.load_state_dict(convert.actor_params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, 0))
    ep_t, bench_t, succ_t, ex_t, eb1_t, _ = tevaluate.evaluate(
        tcfg, [actor], generator=torch.Generator().manual_seed(0),
        device="cpu", init=(tbs, (_t(jobs[0]),)))
    assert succ_t.shape == np.asarray(succ_j).shape == (10, 1)
    assert ep_t.shape == (1,)
    np.testing.assert_allclose(ep_t.numpy(), np.asarray(ep_j), rtol=1e-5)
    np.testing.assert_allclose(float(bench_t), float(bench_j), rtol=1e-5)
    np.testing.assert_array_equal(succ_t.numpy(), np.asarray(succ_j))
    np.testing.assert_allclose(ex_t.numpy(), np.asarray(ex_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(eb1_t), float(eb1_j), rtol=0, atol=1e-5)


def test_superstep_matches_jax_mono_emlp():
    """2 warm + 3 train Mono-EMLP supersteps against the 1-device JAX
    superstep, float32, with JAX's draws (``test_torch_td3.py``'s check:
    one agent, 52-float ring rows, the position-only solved flag)."""
    superstep_vs_jax(**MONO)


def test_train_loop_mono_cpu():
    """``train`` on the CPU for Mono-EMLP at a tiny size: one agent, (B, 4)
    actions, a 52-float ring, the delayed actor step, no kernel launch."""
    from gym_rotor_tpu_torch.train import train
    cfg = TConfig(num_envs=6, max_steps=4, start_timesteps=12, batch_size=8,
                  replay_buffer_size=40, critic_hidden_dim=8,
                  actor_hidden_dim=(8, 4), **MONO)
    before = (ktick.env_tick.launches, kactor.emlp_actor.launches,
              kblock.emlp_block.launches)
    run = train(cfg, 5, device="cpu", log=None)
    assert [s.total_it for s in run["states"]] == [3]
    assert run["replay"].data.shape == (40, 52)
    assert run["obs"][0].shape == (6, 23) and len(run["obs"]) == 1
    assert run["episodes"] and all(len(r) == 1 for _, r in run["episodes"])
    assert (ktick.env_tick.launches, kactor.emlp_actor.launches,
            kblock.emlp_block.launches) == before
