"""PyTorch port vs the JAX package: the reference eval stream
(``envs/ref_stream.py``) and ``evaluate(eval_stream="reference")`` with the
flight-log rows, against ``envs/ref_stream.py`` and
``train.build_eval_rollout``.

Tolerances: the replayed initial conditions bit for bit (the same NumPy and
scipy code); the float64 lift bit for bit where no transcendental enters
and within 16 ulp where ``atan2`` does (``compare_f64``); the float32 lift
within K1's 1e-6 + 1e-5 |JAX|; the eval as ``test_torch_evaluate.py``
holds it (rewards 1e-5 relative, success identical, last |ex| and eb1
1e-5) and the rows within 1e-5 + 1e-5 |JAX| (float32 closed loop over 200
ticks, XLA's jit and torch rounding a tick differently by an ulp here and
there; the rows' columns are O(1)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as jtrain
from gym_rotor_tpu.envs import batch as jbatch
from gym_rotor_tpu.envs import ref_stream as jref
from gym_rotor_tpu.models import zoo as jmodels
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch.convert import actor_params_from_jax
from gym_rotor_tpu_torch.envs import ref_stream as tref
from gym_rotor_tpu_torch.evaluate import evaluate
from gym_rotor_tpu_torch.models.emlp import zoo as tzoo
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from test_torch_env import _tick_draws
from test_torch_integrators import compare_f64

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("n,seed", [(10, 1992), (4, 7)])
def test_reference_eval_inits_bitwise(n, seed):
    got = tref.reference_eval_inits(n, seed)
    ref = jref.reference_eval_inits(n, seed)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == np.float64
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_batched_reset_reference_f64():
    """The lift in float64: state, machine and obs against JAX's."""
    jcfg, tcfg = JConfig(num_envs=10), TConfig(num_envs=10)
    jbs, jobs = jref.batched_reset_reference(jcfg, dtype=jnp.float64)
    tbs, tobs = tref.batched_reset_reference(tcfg, dtype=torch.float64,
                                             device="cpu")
    compare_f64(tbs, jbs, "reference lift",
                exact=("env.x", "env.v", "env.R", "env.W", "env.f_total",
                       "env.M", "traj.b1d", "traj.x_init", "traj.t"))
    inits = tref.reference_eval_inits(10, 1992)
    for k in ("x", "v", "R", "W"):
        np.testing.assert_array_equal(_np(getattr(tbs.env, k)), inits[k])
    np.testing.assert_array_equal(_np(tbs.traj.b1d), inits["b1d"])
    assert not tbs.traj.init_b1d.any() and (_np(tbs.traj.mode) == 0).all()
    for got, ref in zip(tobs, jobs):
        ref = np.asarray(ref)
        assert np.all(np.abs(_np(got) - ref) <= np.spacing(np.abs(ref)))


@pytest.mark.parametrize("exact_so3", [False, True])
def test_batched_reset_reference_f32(exact_so3):
    """The lift in float32 (the eval's dtype), with and without exact_so3:
    within K1's tolerance of JAX's; x, v, W, R and b1d are the float64
    inits rounded once."""
    kw = dict(num_envs=10, exact_so3=exact_so3)
    jbs, jobs = jref.batched_reset_reference(JConfig(**kw))
    tbs, tobs = tref.batched_reset_reference(TConfig(**kw), device="cpu")
    inits = tref.reference_eval_inits(10, 1992)
    for k in ("x", "v", "W") + (() if exact_so3 else ("R",)):
        np.testing.assert_array_equal(_np(getattr(tbs.env, k)),
                                      inits[k].astype(np.float32))
    jt = jax.tree.map(np.asarray, {"env": jbs.env, "traj": jbs.traj})
    from gym_rotor_tpu_torch.utils.tree import tree_named_leaves
    for path, leaf in tree_named_leaves(tbs):
        ref = jt
        for part in path.split("."):
            ref = getattr(ref, part) if not isinstance(ref, dict) else ref[part]
        got = _np(leaf)
        assert got.dtype == np.asarray(ref).dtype, path
        if got.dtype.kind == "f":
            assert np.all(np.abs(got - ref) <= 1e-6 + 1e-5 * np.abs(ref)), path
        else:
            np.testing.assert_array_equal(got, ref, err_msg=path)
    for got, ref in zip(tobs, jobs):
        ref = np.asarray(ref)
        assert np.all(np.abs(_np(got) - ref) <= 1e-6 + 1e-5 * np.abs(ref))


def test_reference_stream_needs_mode_0():
    cfg = TConfig(num_envs=10, train_traj_mode=1)
    with pytest.raises(ValueError, match="mode-0"):
        tref.batched_reset_reference(cfg, device="cpu")
    with pytest.raises(ValueError, match="mode-0"):
        evaluate(cfg.replace(eval_stream="reference"), [], device="cpu")
    with pytest.raises(ValueError, match="eval_stream"):
        evaluate(cfg.replace(eval_stream="sequential"), [], device="cpu")


def test_evaluate_reference_matches_build_eval_rollout():
    """``evaluate(eval_stream="reference", save_log=True)`` with seeded TD3
    EMLP actors (MODUL, RK4), 10 eval envs x 200 ticks, against
    ``train.build_eval_rollout`` with the same actors: JAX's auto-reset
    draws are injected (rebuilt from its keys tick by tick), so env 0's
    flight-log rows agree after a crash too."""
    kw = dict(eval_max_steps=1, eval_stream="reference", save_log=True)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    params, actors = [], []
    for i in range(jcfg.n_agents):
        adef = jmodels.td3_models(jcfg, i).actor_def
        params.append(adef.init(jax.random.PRNGKey(40 + i),
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
    ep_j, bench_j, succ_j, ex_j, eb1_j, rows_j = jtrain.build_eval_rollout(
        jcfg, act_eval)(None, jax.random.PRNGKey(0))
    # JAX's eval replayed tick by tick for the draws its keys give
    ecfg = jcfg.replace(num_envs=jcfg.num_eval)
    jbs, jobs = jref.batched_reset_reference(ecfg, seed=jtrain.EVAL_SEED)
    step = jax.jit(lambda b, a: jbatch.batched_step(ecfg, b, a, "eval"))
    draws_of = jax.jit(lambda b: _tick_draws(b, jnp.float32))
    act = jax.jit(act_eval)
    draws, resets = [], 0
    for _ in range(200):
        draws.append(np.asarray(draws_of(jbs)))
        jbs, out = step(jbs, act(None, jobs))
        jobs = out.obs
        resets += int(out.reset_happened.sum())
    assert resets > 0                     # the auto-reset path is crossed
    ep_t, bench_t, succ_t, ex_t, eb1_t, rows_t = evaluate(
        tcfg, [a for _, a in actors], device="cpu",
        draws=_t(np.stack(draws)))
    rows_j = np.asarray(rows_j)
    assert rows_t.shape == rows_j.shape == (200, 5 + 35)
    np.testing.assert_allclose(ep_t.numpy(), np.asarray(ep_j), rtol=1e-5)
    np.testing.assert_allclose(float(bench_t), float(bench_j), rtol=1e-5)
    np.testing.assert_array_equal(succ_t.numpy(), np.asarray(succ_j))
    np.testing.assert_allclose(ex_t.numpy(), np.asarray(ex_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(eb1_t), float(eb1_j), rtol=0, atol=1e-5)
    err = np.abs(_np(rows_t) - rows_j)
    assert np.all(err <= 1e-5 + 1e-5 * np.abs(rows_j)), err.max()
    # without the log the rows are None
    *_, rows = evaluate(tcfg.replace(save_log=False, eval_max_steps=0.01),
                        [a for _, a in actors], device="cpu")
    assert rows is None
