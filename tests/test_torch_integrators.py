"""PyTorch port vs the JAX package: the Euler and DOP853 integrators, alone
and through the batched tick (plain twins on the CPU; the CUDA kernel's
instances are held to the same twins by chip_smoke.py on the card).

Float64 parity is against JAX run op by op.  ``eager_jit`` compiles a JAX
function with XLA's fusion and algebraic-simplifier passes switched off:
every primitive is then one IEEE operation on its operands, as in eager
mode (no multiply-add contraction, no division by a constant turned into a
multiplication), and it runs a thousand times faster than
``jax.disable_jit()``; ``tests/test_torch_exact_so3.py`` checks it against
``jax.disable_jit()`` bit for bit.  What remains between the two libraries
are the transcendentals: XLA's CPU ``atan2``, ``sin``, ``cos`` and ``exp``
and torch's differ in the last bit on some float64 arguments.  They reach
the reset pose (``euler_to_rot``), the heading and goal of the trajectory
machine and the yaw error, and through the dynamics every continuous field
that depends on those.  ``compare_f64`` therefore holds bitwise the fields
no transcendental reaches (``EXACT_FIELDS``: the randomised parameters,
the step count, the thrust, the machine's clock, planned duration, settle
rate and yaw rate) and every discrete field, and bounds the rest by
``TRANSCENDENTAL_ULPS`` ulps of the field's largest magnitude (or of 1,
where that is smaller: the state is normalised to O(1), and an integral
just reset to ~0 carries the absolute error of the terms it sums).

Float32: JAX runs ``jit`` inside ``jax.enable_x64(False)``, the production
semantics; with x64 on, the JAX float32 DOP853 tick widens to float64
(``dynamics.py:147, 152`` multiply ``dt`` by numpy float64 scalars), which
``test_convert_names_the_cast`` shows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gym_rotor_tpu.envs import batch as jbatch
from gym_rotor_tpu.envs import dynamics as jdyn
from gym_rotor_tpu.ops import so3 as jso3
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch.convert import env_state_from_numpy
from gym_rotor_tpu_torch.envs import batch as tbatch
from gym_rotor_tpu_torch.envs import dynamics as tdyn
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from gym_rotor_tpu_torch.utils.tree import tree_named_leaves
from test_torch_env import (_REWARD_ULP4, _actions, _compare_state,
                            _port_state, _random_params_pair, _t,
                            _tick_draws)

torch.set_num_threads(1)

# the continuous fields no transcendental reaches, held bitwise
EXACT_FIELDS = ("env.f_total", "traj.t", "traj.t_traj", "traj.smooth_term",
                "traj.w_b1d")
TRANSCENDENTAL_ULPS = 16
_UNFUSED = {"xla_disable_hlo_passes": "fusion,algsimp"}


def eager_jit(fn, *args):
    """``fn`` compiled for ``args`` with XLA's fusion and algebraic
    simplification off: op-by-op IEEE semantics at compiled speed."""
    return jax.jit(fn).lower(*args).compile(compiler_options=_UNFUSED)


def _np(t):
    return t.detach().cpu().numpy()


def _jtree(jbs):
    return jax.tree.map(np.asarray, serialization.to_state_dict(jbs))


def compare_f64(tbs, jbs, what="", exact=EXACT_FIELDS):
    """The port's state against JAX's: the discrete fields, the parameters
    and the ``exact`` fields bitwise; every other float field within
    TRANSCENDENTAL_ULPS ulps of its largest magnitude, or of 1 where that is
    smaller.  Returns the worst
    difference per bounded field in those ulps."""
    jt = _jtree(jbs)
    worst = {}
    for path, leaf in tree_named_leaves(tbs):
        ref = jt
        for part in path.split("."):
            ref = ref[part]
        got = _np(leaf)
        assert got.shape == ref.shape and got.dtype == ref.dtype, (what, path)
        if got.dtype.kind == "f" and path not in exact \
                and not path.startswith("env.params."):
            ulp = np.spacing(max(float(np.max(np.abs(ref), initial=0.0)),
                                 1.0))
            d = float(np.max(np.abs(got - ref), initial=0.0)) / ulp
            assert d <= TRANSCENDENTAL_ULPS, f"{what}: {path} {d} ulp"
            worst[path] = d
        else:
            np.testing.assert_array_equal(got, ref, err_msg=f"{what}: {path}")
    return worst


def reward_ulp4(cfg):
    """Four float32 ulp of each agent's raw reward (``|r| <= |rmin|``),
    mapped through the interpolation slope ``1 / |rmin|``."""
    rmin = np.abs([cfg.reward_min_1, cfg.reward_min_2]
                  if cfg.framework == "MODUL" else [cfg.reward_min])
    return 4 * np.spacing(rmin.astype(np.float32)).astype(np.float64) / rmin


def compare_out(cfg, tout, jout, what):
    """Discrete outputs identical; the float32 obs within one float32 ulp
    of their own value (a float64 transcendental's ulp can cross a float32
    rounding boundary), and so the rewards, computed from those obs, within
    ``reward_ulp4``."""
    for k in ("done", "reset_happened"):
        np.testing.assert_array_equal(_np(getattr(tout, k)),
                                      np.asarray(getattr(jout, k)),
                                      err_msg=f"{what}: {k}")
    np.testing.assert_array_equal(_np(tout.info["crashed"]),
                                  np.asarray(jout.info["crashed"]))
    for got, ref in zip(tout.obs, jout.obs):
        ref = np.asarray(ref)
        assert np.all(np.abs(_np(got) - ref) <= np.spacing(np.abs(ref))), what
    diff = np.abs(_np(tout.reward) - np.asarray(jout.reward))
    assert np.all(diff <= reward_ulp4(cfg)), (what, diff.max())


# ---------------------------------------------------------------------------
# The integrators alone
# ---------------------------------------------------------------------------
def test_dop853_tableau_matches_jax():
    """The port's own copy of scipy's tableau is JAX's, bit for bit."""
    A, B, C = tdyn.dop853_tableau()
    np.testing.assert_array_equal(A, jdyn._DOP853_A)
    np.testing.assert_array_equal(B, jdyn._DOP853_B)
    np.testing.assert_array_equal(C, jdyn._DOP853_C)
    assert (A != 0).sum() == 50 and (B != 0).sum() == 8


@pytest.mark.parametrize("name", ["euler", "rk4", "dop853"])
def test_step_bitwise_f64(name):
    """One step of each integrator from 32 random states, float64, JAX
    eager: bitwise (the equations of motion have no transcendental)."""
    rng = np.random.default_rng(11)
    n = 32
    tp, jp = _random_params_pair(rng, n)
    x, v, W, M = (rng.normal(size=(n, 3)) for _ in range(4))
    R = np.asarray(jso3.euler_to_rot(jnp.asarray(rng.uniform(-1, 1, (n, 3)))))
    f = rng.uniform(5, 40, n)
    jargs = tuple(jnp.asarray(a) for a in (x, v, R, W, f, M))
    targs = tuple(_t(a) for a in (x, v, R, W, f, M))
    dt = 0.005
    with jax.disable_jit():
        ref = jdyn.integrate(name, *jargs, jp, jnp.asarray(dt))
    got = tdyn.integrate(name, *targs, tp, torch.tensor(dt, dtype=torch.float64))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(_np(g), np.asarray(r))


def test_dop853_step_f32_rounds_each_coefficient_once():
    """Float32 DOP853 step vs JAX without x64 (each coefficient rounded to
    float32 once, ``dt * a`` in float32): bitwise."""
    rng = np.random.default_rng(12)
    n = 16
    tp, jp = _random_params_pair(rng, n)
    x, v, W, M = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(4))
    R = np.asarray(jso3.euler_to_rot(jnp.asarray(rng.uniform(-1, 1, (n, 3)))),
                   np.float32)
    f = rng.uniform(5, 40, n).astype(np.float32)
    tp32 = type(tp)(**{k: v.float() for k, v in vars(tp).items()})
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    with jax.enable_x64(False):
        jp32 = jax.tree.map(jnp.asarray, jp)
        jargs = tuple(jnp.asarray(a) for a in (x, v, R, W, f, M))
        with jax.disable_jit():
            ref = jdyn.dop853_step(*jargs, jp32, jnp.asarray(0.005, jnp.float32))
        ref = [np.asarray(r) for r in ref]
    got = tdyn.dop853_step(*(_t(a) for a in (x, v, R, W, f, M)), tp32,
                           torch.tensor(0.005, dtype=torch.float32))
    for r, g in zip(ref, got):
        assert r.dtype == np.float32
        np.testing.assert_array_equal(_np(g), r)


# ---------------------------------------------------------------------------
# Through the batched tick
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("framework", ["MODUL", "MONO"])
@pytest.mark.parametrize("integrator", ["euler", "rk4", "dop853"])
def test_rollout_f64(framework, integrator):
    """30 float64 ticks of 8 envs from a JAX reset (mode 0, caps at 12
    ticks and crashes cross auto-resets), the port on its own from the
    converted state with JAX's draws: bitwise to JAX op by op except the
    yaw integral (atan2)."""
    n, ticks = 8, 30
    kw = dict(num_envs=n, max_steps=12, integrator=integrator,
              framework=framework)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jbs, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(21), "train",
                                  jnp.float64)
    tbs = _port_state(jbs, torch.float64)
    rng = np.random.default_rng(22)
    adim = sum(jcfg.action_dim_n)
    step = eager_jit(lambda b, a: jbatch.batched_step(jcfg, b, a), jbs,
                     jnp.zeros((n, adim)))
    draws = jax.jit(lambda b: _tick_draws(b, jnp.float64))
    resets = 0
    for k in range(ticks):
        a = _actions(rng, n)[:, :adim]
        dr = _t(draws(jbs))
        jbs, jout = step(jbs, jnp.asarray(a))
        tbs, tout = tbatch.batched_step(tcfg, tbs, _t(a), dr)
        compare_f64(tbs, jbs, what=f"tick {k}")
        compare_out(jcfg, tout, jout, f"tick {k}")
        resets += int(np.asarray(jout.reset_happened).sum())
    assert resets >= n


@pytest.mark.parametrize("integrator", ["euler", "dop853"])
def test_tick_f32(integrator):
    """Float32 ticks vs JAX under ``jit`` without x64 (12 ticks, 16 envs,
    caps crossed): the state within the float32 tick bound of
    ``test_torch_env.py`` (rtol 2e-5, atol 2e-6: XLA fuses and contracts,
    and the libraries' sin/atan2 differ), rewards within four float32 ulp
    of the raw reward and one of their own value, discrete fields
    identical."""
    n, ticks = 16, 12
    kw = dict(num_envs=n, max_steps=8, integrator=integrator)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    rng = np.random.default_rng(23)
    with jax.enable_x64(False):
        jbs, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(24), "train",
                                      jnp.float32)
        tbs = _port_state(jbs, torch.float32)
        step = jax.jit(lambda b, a: jbatch.batched_step(jcfg, b, a))
        draws = jax.jit(lambda b: _tick_draws(b, jnp.float32))
        for k in range(ticks):
            a = _actions(rng, n).astype(np.float32)
            dr = _t(draws(jbs))
            jbs, jout = step(jbs, jnp.asarray(a))
            assert jbs.env.x.dtype == jnp.float32
            tbs, tout = tbatch.batched_step(tcfg, tbs, _t(a), dr)
            _compare_state(tbs, jbs, rtol=2e-5, atol=2e-6,
                           what=f"f32 {integrator} tick {k}")
            rj = np.asarray(jout.reward)
            bound = _REWARD_ULP4 + np.spacing(np.abs(rj))
            assert np.all(np.abs(_np(tout.reward) - rj) <= bound), k
            np.testing.assert_array_equal(_np(tout.done),
                                          np.asarray(jout.done))


def test_convert_names_the_cast():
    """JAX's float32 DOP853 tick under x64 returns the stepped state
    (``env.x``, ``env.R``, the integrals, ...) in float64 beside float32
    fields (the parameters, the trajectory machine); the converter
    refuses the mixed state unless the cast is named."""
    jcfg = JConfig(num_envs=4, integrator="dop853")
    jbs, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(25), "train",
                                  jnp.float32)
    a = jnp.zeros((4, 5), jnp.float32)
    out_bs, _ = eager_jit(lambda b, a: jbatch.batched_step(jcfg, b, a),
                          jbs, a)(jbs, a)
    assert out_bs.env.x.dtype == jnp.float64
    assert out_bs.env.params.m.dtype == jnp.float32
    tree = _jtree(out_bs)
    with pytest.raises(ValueError, match="pass dtype"):
        env_state_from_numpy(tree, device="cpu")
    st = env_state_from_numpy(tree, device="cpu", dtype=torch.float32)
    assert st.env.x.dtype == torch.float32 and st.env.R.dtype == torch.float32
    np.testing.assert_array_equal(_np(st.env.x),
                                  np.asarray(out_bs.env.x, np.float32))
