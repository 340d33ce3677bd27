"""PyTorch port vs the JAX package: the ``exact_so3`` path (the reference's
repair of R on every read, the stored R left drifted), and the DOP853 /
trajectory-mode training superstep (plain twins on the CPU; the CUDA
kernel's exact_so3 instances are held to the same twins by chip_smoke.py
on the card).

``is_rotation`` takes RᵀR as the fixed-order ``mm3`` and det as a cofactor
expansion where JAX takes ``@`` and an LU ``det``; only the mask has to
agree, and the inputs here stay clear of the 1e-5 edge (a matrix within an
ulp of it may go either way).  The repaired value is ``polar_fast(R, 6)``,
bitwise in float64.

Float64 rollouts against JAX op by op, held as
``test_torch_integrators.compare_f64`` holds them; the float32 superstep
against ``make_sharded_td3_superstep`` inside ``jax.enable_x64(False)``
(with x64 on JAX's float32 DOP853 tick widens to float64 and its rollout
scan refuses the carry), held to ``test_torch_td3.superstep_vs_jax``'s
float32 bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gym_rotor_tpu.envs import batch as jbatch
from gym_rotor_tpu.envs import quad as jquad
from gym_rotor_tpu.envs import trajectory as jtraj
from gym_rotor_tpu.ops import so3 as jso3
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch.envs import batch as tbatch
from gym_rotor_tpu_torch.ops import so3 as tso3
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from test_torch_env import _actions, _port_state, _t, _tick_draws
from test_torch_integrators import compare_f64, compare_out, eager_jit
from test_torch_td3 import TD3, superstep_vs_jax

torch.set_num_threads(1)


def _np(t):
    return t.detach().cpu().numpy()


def _attitudes(rng, n):
    """Clean rotations, drifted ones (1e-4 and 3e-6 off, either side of
    the 1e-5 check), scaled, sheared and reflected matrices."""
    R = np.asarray(jso3.euler_to_rot(jnp.asarray(rng.uniform(-3, 3, (n, 3)))))
    drift = R + 1e-4 * rng.normal(size=R.shape)
    small = R + 3e-6 * rng.uniform(-1, 1, size=R.shape)
    scaled = R * 1.01
    shear = R.copy()
    shear[:, 0, 1] += 0.05
    mirror = R.copy()
    mirror[:, :, 2] *= -1.0
    return np.concatenate([R, drift, small, scaled, shear, mirror])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_is_rotation_and_repair(dtype):
    """The mask and the repaired attitudes against JAX eager: masks
    identical; the repair bitwise in float64 (in float32 within 2 ulp: JAX
    runs without x64 there, XLA's ``det`` and ``@`` sum in another
    order only in the mask)."""
    rng = np.random.default_rng(31)
    R = _attitudes(rng, 16).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        with jax.disable_jit():
            jm = np.asarray(jso3.is_rotation(jnp.asarray(R)))
            jr = np.asarray(jso3.ensure_so3_exact(jnp.asarray(R)))
    tm = _np(tso3.is_rotation(_t(R)))
    tr = _np(tso3.ensure_so3_exact(_t(R)))
    np.testing.assert_array_equal(tm, jm)
    # clean rotations pass, the 1e-4 drift and the deformed ones fail
    assert tm[:16].all() and not tm[16:32].any() and not tm[48:].any()
    assert 0 < tm[32:48].sum()
    assert tr.dtype == dtype
    if dtype == np.float64:
        np.testing.assert_array_equal(tr, jr)
    else:
        np.testing.assert_allclose(tr, jr, rtol=0, atol=2 * 2.0 ** -23)
    np.testing.assert_array_equal(tr[tm], R[tm])          # passthrough
    # the repairs are orthonormal (the reflection stays a reflection)
    RtR = np.einsum("nki,nkj->nij", tr[~tm], tr[~tm])
    assert np.abs(RtR - np.eye(3)).max() < (1e-12 if dtype == np.float64
                                            else 1e-5)


def _mono_euler_exact(n, max_steps, mode=0):
    kw = dict(num_envs=n, max_steps=max_steps, framework="MONO",
              integrator="euler", exact_so3=True, train_traj_mode=mode)
    return JConfig(**kw), TConfig(**kw)


def test_eager_jit_is_eager():
    """``eager_jit`` (XLA without fusion and algebraic simplification) is
    JAX's eager float64 arithmetic bit for bit: the tick's goal and step
    (``get_desired`` in mode 6, ``quad.step`` with Euler and exact_so3 on
    drifted attitudes), every output, on 4 MONO envs.  (The dense fresh
    episode adds threefry's integer ops and ``uniform``'s map, which
    ``test_rollout_mono_euler_exact_f64`` holds through the port.)"""
    n = 4
    jcfg, _ = _mono_euler_exact(n, 60, mode=6)
    jbs, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(32), "train",
                                  jnp.float64)
    rng = np.random.default_rng(33)
    env = jbs.env.replace(R=jbs.env.R + 1e-4 * rng.normal(size=(n, 3, 3)))
    a = jnp.asarray(_actions(rng, n)[:, :4])

    def tick(ts, s, a):
        ts, goal = jtraj.get_desired(ts, s.x, s.v, s.R, s.W, 6)
        return ts, jquad.step(jcfg, s.replace(goal=goal), a)

    got = eager_jit(tick, jbs.traj, env, a)(jbs.traj, env, a)
    with jax.disable_jit():
        ref = tick(jbs.traj, env, a)     # the env functions broadcast
    for x, y in zip(jax.tree.leaves(serialization.to_state_dict(got)),
                    jax.tree.leaves(serialization.to_state_dict(ref))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_rollout_mono_euler_exact_f64():
    """200 float64 ticks of 8 MONO envs with Euler and exact_so3 (caps at
    60 ticks and crashes cross auto-resets), the port on its own from the
    converted JAX reset with JAX's draws, held to JAX op by op as
    ``compare_f64`` holds the tick.  Euler drifts the stored R by ~dt²|W|²
    a tick, so the reads repair it, and the stored R stays drifted."""
    n, ticks = 8, 200
    jcfg, tcfg = _mono_euler_exact(n, 60)
    jbs, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(34), "train",
                                  jnp.float64)
    tbs = _port_state(jbs, torch.float64)
    rng = np.random.default_rng(35)
    step = eager_jit(lambda b, a: jbatch.batched_step(jcfg, b, a), jbs,
                     jnp.zeros((n, 4)))
    draws = jax.jit(lambda b: _tick_draws(b, jnp.float64))
    resets = repaired = 0
    for k in range(ticks):
        a = _actions(rng, n)[:, :4]
        dr = _t(draws(jbs))
        jbs, jout = step(jbs, jnp.asarray(a))
        tbs, tout = tbatch.batched_step(tcfg, tbs, _t(a), dr)
        compare_f64(tbs, jbs, what=f"tick {k}")
        compare_out(jcfg, tout, jout, f"tick {k}")
        resets += int(np.asarray(jout.reset_happened).sum())
        repaired += int((~_np(tso3.is_rotation(tbs.env.R))).sum())
    assert resets >= n and repaired > ticks


def test_superstep_dop853_mode5_f32():
    """Two train TD3 supersteps of 3 ticks and 4 updates (Mod-EMLP,
    narrow; the first samples the 24 rows its own rollout wrote) with
    DOP853 and the circle (mode 5), float32 as JAX runs it without x64,
    against ``make_sharded_td3_superstep``: env, ring, metrics and learner
    states within ``superstep_vs_jax``'s float32 bounds."""
    with jax.enable_x64(False):
        superstep_vs_jax(TD3, supersteps=(0, 2), rollout_len=3, n_updates=4,
                         integrator="dop853", train_traj_mode=5)
