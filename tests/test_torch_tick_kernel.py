"""K1's tile design on the CPU: the premise of its dense fresh episode and
its copy plan.

The tick kernel (``kernels/csrc/env_tick.cu``) computes the fresh episode
of every env of a 32-env tile in a warp of its own, beside the tick, and
keeps it where the episode is over.  That is right only if the fresh chain
does not read the stepped state: JAX's ``batch.py`` ``fresh(s)`` reads
``s.key`` alone, and the port's ``_fresh`` the draws and the config.  The
first test holds both to that (bitwise, float64), and the port's fresh
state to JAX's.

The kernel moves every buffer through shared memory in whole runs: a plan
made on the host (``env_tick.copy_plan``) gives each field to one warp,
whose lanes move its run.  The second test replays the kernel's copies in
Python over those plans: every env and every field of every buffer is
written exactly once, and every image slot read in.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gym_rotor_tpu.envs import batch as jbatch
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch.envs import batch as tbatch
from gym_rotor_tpu_torch.kernels import env_tick as K
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from gym_rotor_tpu_torch.utils.tree import tree_named_leaves
from test_torch_env import _compare_state, _port_state, _t, _tick_draws

torch.set_num_threads(1)
TILE = 32


def _with_keys(jbs, keys_from):
    """``jbs`` with the env and machine keys of ``keys_from``."""
    return jbs.replace(env=jbs.env.replace(key=keys_from.env.key),
                       traj=jbs.traj.replace(key=keys_from.traj.key))


def _at_cap(jbs, cfg):
    return jbs.replace(env=jbs.env.replace(
        t=jnp.full_like(jbs.env.t, cfg.max_steps - 1)))


def _leaves(tree):
    flat = jax.tree.map(np.asarray, serialization.to_state_dict(tree))
    return jax.tree_util.tree_flatten_with_path(flat)[0]


@pytest.mark.parametrize("framework", ["MODUL", "MONO"])
@pytest.mark.parametrize("mode", [0, 3])
@pytest.mark.parametrize("exact", [False, True])
def test_fresh_reads_only_its_draws(framework, mode, exact):
    """Two states that differ in everything but their keys, every episode
    at its cap: JAX's tick gives both the same fresh state, machine and obs
    bit for bit in float64, and so does the port's plain tick on the draws
    of those keys; the port's fresh episode is JAX's up to the math
    libraries' transcendentals."""
    n = 8
    kw = dict(num_envs=n, max_steps=5, framework=framework,
              train_traj_mode=mode, exact_so3=exact)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    ja, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(3), "train",
                                 jnp.float64)
    jb, _ = jbatch.batched_reset(jcfg, jax.random.PRNGKey(7), "train",
                                 jnp.float64)
    ja, jb = _at_cap(ja, jcfg), _at_cap(_with_keys(jb, ja), jcfg)
    rng = np.random.default_rng(1)
    a = rng.normal(0.0, 0.3, (n, sum(tcfg.action_dim_n)))
    step = jax.jit(lambda b, x: jbatch.batched_step(jcfg, b, x))
    (ja2, jout_a), (jb2, jout_b) = step(ja, jnp.asarray(a)), step(
        jb, jnp.asarray(a))
    assert bool(np.all(np.asarray(jout_a.reset_happened)))
    for (p, x), (_, y) in zip(_leaves(ja2), _leaves(jb2)):
        np.testing.assert_array_equal(x, y, err_msg=str(p))
    for x, y in zip(jout_a.obs, jout_b.obs):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    draws = _t(_tick_draws(ja, jnp.float64))
    np.testing.assert_array_equal(draws.numpy(),
                                  np.asarray(_tick_draws(jb, jnp.float64)))
    ta, tb = _port_state(ja, torch.float64), _port_state(jb, torch.float64)
    ta2, tout_a = tbatch.batched_step_plain(tcfg, ta, _t(a), draws)
    tb2, tout_b = tbatch.batched_step_plain(tcfg, tb, _t(a), draws)
    for (path, x), (_, y) in zip(tree_named_leaves(ta2),
                                 tree_named_leaves(tb2)):
        assert torch.equal(x, y), path
    for x, y in zip(tout_a.obs, tout_b.obs):
        assert torch.equal(x, y)

    # the port's fresh episode against JAX's: discrete fields equal, the
    # rest bitwise up to the two math libraries' sin / cos / atan2 (the
    # bound of test_torch_env.test_batched_step_eager_f64)
    _compare_state(ta2, ja2, rtol=1e-13, atol=1e-14, what="fresh")
    for x, y in zip(tout_a.obs, jout_a.obs):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-13,
                                   atol=1e-14)


def _buffers():
    """(name, [(path, offset, width)]) of each buffer the tile kernel copies
    by a plan: the float state and each batched task's float and bool
    outputs."""
    state = [(p, o, w) for p, o, w, _ in K.layout()[torch.float32]]
    out = [("state", state)]
    for task in K.BATCHED_TASKS:
        for kind in ("F", "B"):
            fields, off = [], 0
            for name, w in K.OUT[task][kind]:
                fields.append((name, off, w))
                off += w
            out.append((f"{task}.{kind}", fields))
    return out


@pytest.mark.parametrize("warps", [K.COPY_WARPS - 1, K.COPY_WARPS])
@pytest.mark.parametrize("B", [1, 31, 32, 33, 100])
def test_copy_plan_covers_every_field_once(B, warps):
    """``copy_plan`` gives every field of every buffer to exactly one warp,
    the warps' register slots do not overlap, and the lanes' scalars ``l +
    32 i`` (``i < width``) of a field's run cover each env's columns once:
    over the tiles of ``B`` envs the copy out writes every scalar of every
    buffer once, from the image slot of its own env and column, and the copy
    in fills every image slot (the tile's last env for slots past it)."""
    for name, fields in _buffers():
        plan = K.copy_plan([(o, w) for _, o, w in fields], warps)
        assert len(plan) == warps
        got = sorted((off, w) for rows, _ in plan for off, w, _ in rows)
        assert got == sorted((o, w) for _, o, w in fields), name
        for rows, n in plan:
            flat = sorted(s for _, w, b in rows for s in range(b, b + w))
            assert flat == list(range(n)), (name, rows)
        n_cols = fields[-1][1] + fields[-1][2]
        written = np.zeros(n_cols * B, np.int64)
        for i0 in range(0, B, TILE):
            ne = min(TILE, B - i0)
            filled = np.zeros(n_cols * TILE, np.int64)
            for rows, _ in plan:
                for off, w, _ in rows:
                    for lane in range(32):
                        for i in range(w):
                            j = lane + 32 * i
                            e, c = j // w, j % w
                            filled[off * TILE + j] += 1
                            ge = min(e, ne - 1)
                            g_in = off * B + (i0 + ge) * w + c
                            assert off * B <= g_in < (off + w) * B
                            if e < ne:
                                written[off * B + i0 * w + j] += 1
            np.testing.assert_array_equal(filled, 1, err_msg=name)
        np.testing.assert_array_equal(written, 1, err_msg=name)


def test_copy_macros_in_the_header():
    """The generated header carries each plan as its warps' macro lists,
    the float outputs' obs slots first (the copy out takes the fresh obs
    for the columns below ``NOBS``)."""
    h = K.layout_header()["env_tick_layout.h"]
    state = [(o, w) for _, o, w, _ in K.layout()[torch.float32]]
    for name, warps in (("K1_SF", K.COPY_WARPS), ("K1_SFI", K.COPY_WARPS - 1)):
        plan = K.copy_plan(state, warps)
        for k, (rows, n) in enumerate(plan):
            body = " ".join(f"X({o}, {w}, {b})" for o, w, b in rows)
            assert f"#define {name}_W{k}(X) {body}\n" in h
            assert f"#define {name}_N{k} {n}\n" in h
        assert f"#define {name}_NMAX {max(n for _, n in plan)}\n" in h
    assert [s for s, _ in K.OUT["decoupled"]["F"][:2]] == ["obs1", "obs2"]
    assert [s for s, _ in K.OUT["coupled"]["F"][:1]] == ["obs1"]


@pytest.mark.parametrize("w", [1, 4, 5, 25])
def test_packed_columns_find_the_env(w):
    """The kernel's small copies (ints, bools: width 1; actions: 4 or 5;
    draws: 25) find a scalar's env as ``(j * m) >> 16`` with ``m =
    ceil(2**16 / w)``: exact over a tile's run."""
    m = -(-(1 << 16) // w)
    assert all((j * m) >> 16 == j // w for j in range(TILE * w))
