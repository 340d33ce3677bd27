"""PyTorch port vs the JAX package: SO(3) math, dynamics, reset and the
batched tick (plain twins on the CPU; the CUDA kernel is held to the same
twins by chip_smoke.py on the card).

Inputs come from numpy seeds; random draws are JAX's own, re-derived from
the JAX state's keys by ``_tick_draws``/``_reset_draws`` in the port's
injected-draw layout (gym_rotor_tpu_torch/envs/draws.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gym_rotor_tpu.envs import batch as jbatch
from gym_rotor_tpu.envs import dynamics as jdyn
from gym_rotor_tpu.envs import params as jparams
from gym_rotor_tpu.ops import so3 as jso3
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch.convert import env_state_from_numpy
from gym_rotor_tpu_torch.envs import batch as tbatch
from gym_rotor_tpu_torch.envs import dynamics as tdyn
from gym_rotor_tpu_torch.envs import params as tparams
from gym_rotor_tpu_torch.ops import so3 as tso3
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from gym_rotor_tpu_torch.utils.tree import tree_named_leaves

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# JAX draws in the port's layout
# ---------------------------------------------------------------------------
def _tick_draws(bs, dtype):
    """The (B, N_DRAWS) base draws the JAX tick consumes from ``bs``'s keys:
    the current machine's mode-0 heading (trajectory.py:137-141) and mode-1
    settle time and yaw rate (:158-163), batch.py:110 -> quad.py:417
    (params.py:107, quad.py:401-402, :431) for the fresh episode, and the
    fresh machine's three (each mode reads its own)."""
    def one(ek, tk):
        k1, k2 = jax.random.split(ek)
        return _layout(_machine_draws(tk, dtype), *_reset_slots(k1, k2, dtype))
    return jax.vmap(one)(bs.env.key, bs.traj.key)


def _machine_draws(tk, dtype):
    """(theta, hover_t, hover_w): the base draws behind ``_mode_idle``'s
    ``split(key)`` and ``_mode_hover``'s ``split(key, 3)`` on a machine
    whose key is ``tk``."""
    _, sub = jax.random.split(tk)
    _, k1, k2 = jax.random.split(tk, 3)
    return jnp.stack([jax.random.uniform(k, (), dtype) for k in (sub, k1, k2)])


def _reset_slots(ek, tk, dtype):
    """A fresh episode's slots: UDM, at-origin and the 12 reset uniforms
    from the env key ``ek``; the fresh machine's three from ``tk``."""
    k_param, k_branch, k_x, _ = jax.random.split(ek, 4)
    udm = jax.random.uniform(k_param, (6,), dtype)
    _, sb = jax.random.split(k_branch)
    at_origin = jax.random.uniform(sb, ()).astype(dtype)
    r12 = jax.random.uniform(k_x, (12,), dtype)
    return jnp.concatenate([udm, at_origin[None], r12]), _machine_draws(tk, dtype)


def _layout(cur, env_slots, fresh):
    """One env's row in ``envs/draws.py``'s slot order."""
    return jnp.concatenate([cur[:1], env_slots, fresh[:1], cur[1:], fresh[1:]])


def _reset_draws(key, n, dtype):
    """Draws of ``batched_reset(cfg, key)`` (batch.py:54-56)."""
    ek, tk = jax.random.split(key)
    eks, tks = jax.random.split(ek, n), jax.random.split(tk, n)
    return jax.vmap(lambda e, t: _layout(jnp.zeros(3, dtype),
                                         *_reset_slots(e, t, dtype)))(eks, tks)


def _port_state(jbs, dtype):
    tree = jax.tree.map(np.asarray, serialization.to_state_dict(jbs))
    return env_state_from_numpy(tree, device="cpu", dtype=dtype)


def _compare_state(tbs, jbs, rtol, atol, what):
    """Continuous fields within tolerance, discrete fields identical."""
    jtree = jax.tree.map(np.asarray, serialization.to_state_dict(jbs))
    worst = 0.0
    for path, leaf in tree_named_leaves(tbs):
        ref = jtree
        for part in path.split("."):
            ref = ref[part]
        got = _np(leaf)
        assert got.shape == ref.shape, (what, path)
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                                       err_msg=f"{what}: {path}")
            worst = max(worst, float(np.max(np.abs(got - ref), initial=0)))
        else:
            np.testing.assert_array_equal(got, ref, err_msg=f"{what}: {path}")
    return worst


# ---------------------------------------------------------------------------
# so3 + dynamics, float64 eager: bitwise where no transcendental enters
# ---------------------------------------------------------------------------
def test_so3_matches_jax_f64():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(32, 3))
    A = rng.normal(size=(32, 3, 3))
    B = rng.normal(size=(32, 3, 3))
    R = np.asarray(jso3.euler_to_rot(jnp.asarray(rng.uniform(-1, 1, (32, 3)))))
    R = R + 1e-3 * rng.normal(size=R.shape)        # drifted attitude
    exact = [
        (jso3.hat(w), tso3.hat(_t(w))),
        (jso3.vee(A), tso3.vee(_t(A))),
        (jso3.cross(A[:, 0], B[:, 1]), tso3.cross(_t(A[:, 0]), _t(B[:, 1]))),
        (jso3.mm3(A, B), tso3.mm3(_t(A), _t(B))),
        (jdyn.mv3(A, B[:, 0]), tdyn.mv3(_t(A), _t(B[:, 0]))),
        (jdyn.dot3(A[:, 0], B[:, 0]), tdyn.dot3(_t(A[:, 0]), _t(B[:, 0]))),
        (jso3.inv3(A), tso3.inv3(_t(A))),
        (jso3.polar_fast(R), tso3.polar_fast(_t(R))),
    ]
    for ref, got in exact:
        np.testing.assert_array_equal(_np(got), np.asarray(ref))
    e = rng.uniform(-3, 3, (32, 3))
    # sin/cos come from different libraries: agree to an ulp or two
    for ref, got in [(jso3.euler_to_rot(e), tso3.euler_to_rot(_t(e))),
                     (jso3.rot_x(e[:, 0]), tso3.rot_x(_t(e[:, 0]))),
                     (jso3.rot_y(e[:, 1]), tso3.rot_y(_t(e[:, 1]))),
                     (jso3.rot_z(e[:, 2]), tso3.rot_z(_t(e[:, 2])))]:
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0,
                                   atol=4e-16)


def _random_params_pair(rng, n):
    u = rng.uniform(0, 1, (n, 6))
    tp = tparams.randomize(_t(u), 10.0)
    z = 2.0 * u - 1.0                              # uniform_in(u, -1, 1)
    jp = jax.vmap(lambda zz: jparams.from_values(*_udm_values(zz)))(
        jnp.asarray(z))
    return tp, jp


def _udm_values(z):
    nom = jnp.asarray([jparams.M_NOMINAL, jparams.D_NOMINAL,
                       jparams.J_NOMINAL[0], jparams.J_NOMINAL[2],
                       jparams.C_TF_NOMINAL, jparams.C_TW_NOMINAL])
    frac = jnp.asarray([0.1, 0.1, 0.1, 0.1, 0.1, 0.05])
    vals = nom + nom * frac * z
    return tuple(vals[i] for i in range(6))


def test_params_eom_rk4_bitwise_f64():
    rng = np.random.default_rng(1)
    n = 32
    tp, jp = _random_params_pair(rng, n)
    for f in dataclasses.fields(tp):
        np.testing.assert_array_equal(_np(getattr(tp, f.name)),
                                      np.asarray(getattr(jp, f.name)),
                                      err_msg=f.name)
    x, v, W, M = (rng.normal(size=(n, 3)) for _ in range(4))
    R = np.asarray(jso3.euler_to_rot(jnp.asarray(rng.uniform(-1, 1, (n, 3)))))
    f = rng.uniform(5, 40, n)
    jargs = tuple(jnp.asarray(a) for a in (x, v, R, W, f, M))
    targs = tuple(_t(a) for a in (x, v, R, W, f, M))
    for ref, got in zip(jdyn.eom(*jargs, jp), tdyn.eom(*targs, tp)):
        np.testing.assert_array_equal(_np(got), np.asarray(ref))
    dt = 0.005
    for ref, got in zip(jdyn.rk4_step(*jargs, jp, jnp.asarray(dt)),
                        tdyn.rk4_step(*targs, tp, torch.tensor(dt, dtype=torch.float64))):
        np.testing.assert_array_equal(_np(got), np.asarray(ref))


# ---------------------------------------------------------------------------
# reset + batched tick
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("env_type", ["train", "eval"])
def test_reset_matches_jax_f64(env_type):
    jcfg = JConfig(num_envs=64)
    tcfg = TConfig(num_envs=64)
    key = jax.random.PRNGKey(7)
    jbs, jobs = jbatch.batched_reset(jcfg, key, env_type, jnp.float64)
    draws = _t(_reset_draws(key, 64, jnp.float64))
    tbs, tobs = tbatch.batched_reset(tcfg, None, env_type, torch.float64,
                                     device="cpu", draws=draws)
    # atan2/sin/cos of the reset pose: a few ulp between math libraries
    _compare_state(tbs, jbs, rtol=1e-13, atol=1e-14, what=f"reset {env_type}")
    for ref, got in zip(jobs, tobs):
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)
        assert got.dtype == torch.float32


# four float32 ulp of the raw per-agent reward (|r| <= |rmin|), mapped
# through the interpolation slope 1/|rmin|
_RMIN = np.asarray([abs(JConfig().reward_min_1), abs(JConfig().reward_min_2)])
_REWARD_ULP4 = 4 * np.spacing(_RMIN.astype(np.float32)).astype(np.float64) / _RMIN


def _actions(rng, n):
    """Near-hover actions with enough spread that some envs crash."""
    a = rng.normal(0.0, 0.35, size=(n, 5))
    a[:, 0] = rng.uniform(-0.4, 0.1, n)
    return a


def test_batched_step_rollout_f64():
    """200 ticks, 64 envs, max_steps lowered so caps and crash resets both
    happen; the port runs on its own from the converted initial state."""
    n, ticks = 64, 200
    jcfg = JConfig(num_envs=n, max_steps=60)
    tcfg = TConfig(num_envs=n, max_steps=60)
    jbs, jobs = jbatch.batched_reset(jcfg, jax.random.PRNGKey(3), "train",
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
        np.testing.assert_array_equal(_np(tout.done), np.asarray(jout.done))
        np.testing.assert_array_equal(_np(tout.reset_happened),
                                      np.asarray(jout.reset_happened))
        np.testing.assert_array_equal(_np(tout.info["crashed"]),
                                      np.asarray(jout.info["crashed"]))
        # rewards are computed from the float32 obs (quad.py:188-189), in
        # float32 arithmetic that XLA's jit may contract differently (four
        # product terms per agent): within four float32 ulp of the raw reward
        # before its [rmin, 0] -> [0, 1] interpolation (bitwise in the eager
        # test below)
        diff = np.abs(_np(tout.reward) - np.asarray(jout.reward))
        assert np.all(diff <= _REWARD_ULP4), (k, diff.max(0))
        for ref, got in zip(jout.obs + jout.info["terminal_obs"],
                            tout.obs + tout.info["terminal_obs"]):
            np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6,
                                       atol=1e-6)
        resets += int(np.asarray(jout.reset_happened).sum())
        caps += int((np.asarray(jout.reset_happened)
                     & ~np.asarray(jout.info["crashed"]).any(-1)).sum())
    assert resets > 20 and caps > 20, (resets, caps)
    assert worst < 1e-10


def test_batched_step_eager_f64():
    """Eager float64 JAX ticks (no XLA fusion at all): a step and a capped
    step with its fresh episode, bitwise up to the math library's
    transcendentals."""
    n = 8
    jcfg = JConfig(num_envs=n, max_steps=2)
    tcfg = TConfig(num_envs=n, max_steps=2)
    jbs, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(11), "train",
                                  jnp.float64)
    tbs = _port_state(jbs, torch.float64)
    rng = np.random.default_rng(2)
    for k in range(2):                 # the second tick hits the cap
        a = _actions(rng, n)
        draws = _t(_tick_draws(jbs, jnp.float64))
        with jax.disable_jit():
            jbs, jout = jbatch.batched_step(jcfg, jbs, jnp.asarray(a))
        tbs, tout = tbatch.batched_step(tcfg, tbs, _t(a), draws)
        _compare_state(tbs, jbs, rtol=1e-13, atol=1e-14, what=f"eager {k}")
        np.testing.assert_array_equal(_np(tout.reset_happened),
                                      np.asarray(jout.reset_happened))
        np.testing.assert_array_equal(_np(tout.reward), np.asarray(jout.reward))


def test_batched_step_f32():
    """Float32 port vs the JAX float32 tick (run with x64 on, as the suite
    does).  ``quad._interp01`` widens to float64 under x64 while the port's
    float32 path stays in float32, so on top of the jit contraction bound of
    the float64 test the reward may differ by one more float32 ulp;
    the state itself agrees to a few ulp of its magnitude (different sin/
    atan2 libraries and XLA's own fusion)."""
    n, ticks = 64, 20
    jcfg = JConfig(num_envs=n, max_steps=12)
    tcfg = TConfig(num_envs=n, max_steps=12)
    jbs, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(4), "train",
                                  jnp.float32)
    tbs = _port_state(jbs, torch.float32)
    jstep = jax.jit(lambda b, a: jbatch.batched_step(jcfg, b, a))
    jdraws = jax.jit(lambda b: _tick_draws(b, jnp.float32))
    rng = np.random.default_rng(6)
    for k in range(ticks):
        a = _actions(rng, n).astype(np.float32)
        draws = _t(jdraws(jbs))
        jbs, jout = jstep(jbs, jnp.asarray(a))
        tbs, tout = tbatch.batched_step(tcfg, tbs, _t(a), draws)
        _compare_state(tbs, jbs, rtol=2e-5, atol=2e-6, what=f"f32 tick {k}")
        rj = np.asarray(jout.reward)
        bound = _REWARD_ULP4 + np.spacing(np.abs(rj))
        assert np.all(np.abs(_np(tout.reward) - rj) <= bound), k
        np.testing.assert_array_equal(_np(tout.done), np.asarray(jout.done))
