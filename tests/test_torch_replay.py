"""PyTorch port vs the JAX package: the replay ring (K2's plain twin) and
the episode statistics carried in the same launch (K8's).  Inputs come
from numpy seeds; the CUDA kernels are held to these twins by
chip_smoke.py on the card.

The ring is a copy: its contents, cursor and fill are bitwise JAX's.  The
episode statistics add the same float32 values in the same order per tick
(``ep_ret`` bitwise); the cross-env sums agree to float32 summation order.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from jax.sharding import PartitionSpec as P

from gym_rotor_tpu.algos import replay as jreplay
from gym_rotor_tpu.envs.batch import Transition as JTransition
from gym_rotor_tpu.parallel import mesh as jmesh
from gym_rotor_tpu.parallel.train_step import _episode_stats
from gym_rotor_tpu_torch.algos import replay as treplay
from gym_rotor_tpu_torch.convert import replay_state_from_jax
from gym_rotor_tpu_torch.envs.batch import Transition as TTransition
from gym_rotor_tpu_torch.kernels import replay as kreplay

torch.set_num_threads(1)
OBS, ACT = (15, 3), (4, 1)          # MODUL: 45 floats a row


def _np(t):
    return t.detach().cpu().numpy()


def _tick(rng, b):
    """One tick's transition fields as float32 numpy arrays."""
    obs = tuple(rng.normal(size=(b, d)).astype(np.float32) for d in OBS)
    nxt = tuple(rng.normal(size=(b, d)).astype(np.float32) for d in OBS)
    act = rng.uniform(-1, 1, (b, sum(ACT))).astype(np.float32)
    rwd = rng.uniform(0, 1, (b, 2)).astype(np.float32)
    done = rng.uniform(size=(b, 2)) < 0.2
    return obs, act, rwd, nxt, done


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_ring(rs):
    return jax.tree.map(np.asarray, serialization.to_state_dict(rs))


def test_row_layout_matches_jax():
    assert treplay.row_dim(OBS, ACT) == jreplay.row_dim(OBS, ACT) == 45
    cols = kreplay.column_map((OBS, ACT))
    assert cols.shape == (45,)
    # field and source column of every ring column, in JAX's _pack order
    fields = [0] * 15 + [1] * 3 + [2] * 5 + [3] * 2 + [4] * 15 + [5] * 3 + [6] * 2
    np.testing.assert_array_equal(cols >> 8, fields)


def test_insert_wraparound_bitwise():
    """Blocks of 7 rows into a ring of 16 (wrapping twice), through
    ``insert_tick`` and ``insert`` in turn: data, cursor and fill equal to
    JAX's after every insert, from a ring converted from JAX's empty one."""
    rng = np.random.default_rng(0)
    jrs = jreplay.create(16, OBS, ACT)
    trs = replay_state_from_jax(_jax_ring(jrs), OBS, ACT, device="cpu")
    for k in range(5):
        obs, act, rwd, nxt, done = _tick(rng, 7)
        if k % 2:
            per_agent = (obs, (act[:, :4], act[:, 4:]), (rwd[:, 0], rwd[:, 1]),
                         nxt, (done[:, 0], done[:, 1]))
            jrs = jreplay.insert(jrs, *([jnp.asarray(a) for a in f]
                                        for f in per_agent))
            treplay.insert(trs, *([_t(a) for a in f] for f in per_agent))
        else:
            jrs = jreplay.insert_tick(jrs, tuple(map(jnp.asarray, obs)),
                                      jnp.asarray(act), jnp.asarray(rwd),
                                      tuple(map(jnp.asarray, nxt)),
                                      jnp.asarray(done))
            treplay.insert_tick(trs, tuple(map(_t, obs)), _t(act), _t(rwd),
                                tuple(map(_t, nxt)), _t(done))
        np.testing.assert_array_equal(_np(trs.data), np.asarray(jrs.data))
        assert (trs.ptr, trs.filled) == (int(jrs.ptr), int(jrs.filled))
    for f in ("obs", "act", "rwd", "next_obs", "done"):
        for a, b in zip(getattr(trs, f), getattr(jrs, f)):
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=f)


def test_insert_tick_matches_insert_rollout():
    """T ticks of ``insert_tick`` leave the ring ``insert_rollout`` of the
    stacked (T, B) transitions leaves, in the port and in JAX."""
    rng = np.random.default_rng(1)
    T, b = 3, 5
    ticks = [_tick(rng, b) for _ in range(T)]
    t_tick = treplay.create(12, OBS, ACT, device="cpu")
    for obs, act, rwd, nxt, done in ticks:
        treplay.insert_tick(t_tick, tuple(map(_t, obs)), _t(act), _t(rwd),
                            tuple(map(_t, nxt)), _t(done))

    def stack(i):
        return np.stack([tk[i] for tk in ticks])
    obs_s = tuple(np.stack([tk[0][a] for tk in ticks]) for a in range(2))
    nxt_s = tuple(np.stack([tk[3][a] for tk in ticks]) for a in range(2))
    t_roll = treplay.create(12, OBS, ACT, device="cpu")
    treplay.insert_rollout(t_roll, TTransition(
        tuple(map(_t, obs_s)), _t(stack(1)), _t(stack(2)),
        tuple(map(_t, nxt_s)), _t(stack(4))))
    j_roll = jreplay.insert_rollout(jreplay.create(12, OBS, ACT), JTransition(
        tuple(map(jnp.asarray, obs_s)), jnp.asarray(stack(1)),
        jnp.asarray(stack(2)), tuple(map(jnp.asarray, nxt_s)),
        jnp.asarray(stack(4))))
    np.testing.assert_array_equal(_np(t_tick.data), _np(t_roll.data))
    np.testing.assert_array_equal(_np(t_roll.data), np.asarray(j_roll.data))
    assert (t_tick.ptr, t_tick.filled) == (t_roll.ptr, t_roll.filled) == (
        int(j_roll.ptr), int(j_roll.filled))


def test_sample_with_jax_indices_bitwise():
    """``sample`` with the indices JAX's ``sample`` draws from its key
    (``randint`` over ``[0, max(filled, 1))``) returns JAX's batch."""
    rng = np.random.default_rng(2)
    jrs = jreplay.create(64, OBS, ACT)
    obs, act, rwd, nxt, done = _tick(rng, 40)
    jrs = jreplay.insert_tick(jrs, tuple(map(jnp.asarray, obs)),
                              jnp.asarray(act), jnp.asarray(rwd),
                              tuple(map(jnp.asarray, nxt)), jnp.asarray(done))
    trs = replay_state_from_jax(_jax_ring(jrs), OBS, ACT, device="cpu")
    key = jax.random.PRNGKey(3)
    jb = jreplay.sample(jrs, key, 16)
    idx = jax.random.randint(key, (16,), 0, jnp.maximum(jrs.filled, 1))
    assert int(idx.max()) < 40
    tb = treplay.sample(trs, 16, idx=_t(idx).long())
    for f in ("obs", "act", "rwd", "next_obs", "done"):
        for a, b in zip(getattr(tb, f), getattr(jb, f)):
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=f)


def test_empty_ring_sample_is_poisoned():
    jb = jreplay.sample(jreplay.create(8, OBS, ACT), jax.random.PRNGKey(0), 4)
    tb = treplay.sample(treplay.create(8, OBS, ACT, device="cpu"), 4,
                        generator=torch.Generator().manual_seed(0))
    for f in ("obs", "act", "rwd", "next_obs", "done"):
        for a, b in zip(getattr(jb, f), getattr(tb, f)):
            assert np.isnan(np.asarray(a)).all() and bool(torch.isnan(b).all())
            assert tuple(b.shape) == a.shape


def test_episode_stats_match_roll_body():
    """K8's twin, tick by tick inside the ring write, against the JAX
    episode bookkeeping (``_episode_stats``, the same lines as
    ``roll_body``'s, on a 1-device mesh): ``ep_ret`` bitwise, finished sums,
    counts and the reward sum within float32 summation order."""
    rng = np.random.default_rng(4)
    T, b = 6, 32
    rewards = rng.uniform(-1, 1, (T, b, 2)).astype(np.float32)
    resets = rng.uniform(size=(T, b)) < 0.3
    ep0 = rng.normal(size=(b, 2)).astype(np.float32)
    mesh = jmesh.make_mesh(1)
    stats_fn = jax.jit(jax.shard_map(
        partial(_episode_stats, "env"), mesh=mesh,
        in_specs=(P("env"), P(None, "env"), P(None, "env")),
        out_specs=(P("env"), P(), P())))
    j_ep, j_fin, j_cnt = stats_fn(jnp.asarray(ep0), jnp.asarray(rewards),
                                  jnp.asarray(resets))
    ring = treplay.create(T * b, OBS, ACT, device="cpu")
    ep = _t(ep0)
    stats = torch.zeros(4)
    for k in range(T):
        obs, act, _, nxt, done = _tick(rng, b)
        treplay.insert_tick(ring, tuple(map(_t, obs)), _t(act),
                            _t(rewards[k]), tuple(map(_t, nxt)), _t(done),
                            reset=_t(resets[k]), ep_ret=ep, stats=stats)
    np.testing.assert_array_equal(_np(ep), np.asarray(j_ep))
    np.testing.assert_allclose(_np(stats[:2]), np.asarray(j_fin), rtol=1e-6,
                               atol=1e-6)
    assert float(stats[2]) == float(j_cnt) == float(resets.sum())
    np.testing.assert_allclose(float(stats[3]), float(rewards.sum()),
                               rtol=1e-6, atol=1e-5)
    # the ring rows carry the rewards the stats saw
    np.testing.assert_array_equal(_np(torch.cat(ring.rwd, -1)),
                                  rewards.reshape(T * b, 2))


@pytest.mark.parametrize("rows", [1, 33])
def test_insert_plain_twin_checks(rows):
    """The plain twin writes ``rows`` rows at ``(ptr + b) % cap`` in place
    and leaves the rest of the ring as it was."""
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.normal(size=(40, 45)).astype(np.float32))
    before = data.clone()
    obs, act, rwd, nxt, done = _tick(rng, rows)
    kreplay.replay_insert_tick(data, 30, (OBS, ACT), tuple(map(_t, obs)),
                               _t(act), _t(rwd), tuple(map(_t, nxt)),
                               _t(done))
    slots = (30 + np.arange(rows)) % 40
    keep = np.setdiff1d(np.arange(40), slots)
    np.testing.assert_array_equal(_np(data[keep]), _np(before[keep]))
    np.testing.assert_array_equal(
        _np(data[slots]),
        np.concatenate(list(obs) + [act, rwd] + list(nxt)
                       + [done.astype(np.float32)], axis=1))
