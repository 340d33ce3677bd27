"""K2 write + K8's one-launch design on the CPU: a torch emulation of the
kernel's ring indexing and of its order of summation, held to the plain
twin and to the JAX arithmetic it replaces.

``kernels/csrc/replay.cu`` gives each block a 32-row tile.  Thread ``t``
of 256 writes the tile's ring elements ``t, t + 256, ...``, stepping its
(row, column) by fixed increments; the tile's rows land at one or two
contiguous runs of the ring (``ptr + r0`` less ``cap`` once, the rows from
``cap - first`` on moved back by ``cap`` rows).  K8's per-row terms are
summed by a butterfly of shuffles within the tile; the tiles' sums by 32
lanes, each a run of tiles in order, then the same butterfly
(``k8_order_sums``).  JAX's side is
``replay.insert_tick`` and ``train_step.py``'s ``roll_body`` lines (ep +=
reward, the finished returns, count and reward sums, ep reset).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_rotor_tpu.algos import replay as jreplay
from gym_rotor_tpu_torch.kernels import replay as kreplay

torch.set_num_threads(1)
TILE, THREADS, MAX_ROW = 32, 256, 128
DIMS = {"MODUL": ((15, 3), (4, 1)), "MONO": ((23,), (4,))}


def k8_order_sums(reward, reset, ep_ret, tile=TILE):
    """K8's cross-env sums in the kernel's order: per tile of ``tile`` rows
    the per-row terms (finished returns per agent, the finished count, the
    reward sum ``(0 + r_0) + r_1``), rows past ``B`` zero, summed by the
    butterfly ``q += q[lane ^ h]`` for ``h = tile/2 .. 1``; one tile is the
    sum; with more, lane ``l`` of 32 adds the tiles ``[l c, (l + 1) c)`` in
    order (``c = ceil(tiles / 32)``, an empty range 0) and the lanes go
    through the same butterfly.  Returns the ``(n + 2,)`` increments of
    ``stats`` (the kernel adds them to ``stats`` once)."""
    B, n = reward.shape
    ep = ep_ret + reward
    fin = torch.where(reset[:, None], ep, torch.zeros_like(ep))
    rsum = torch.zeros_like(reward[:, 0])
    for a in range(n):
        rsum = rsum + reward[:, a]
    q = torch.cat([fin, reset.to(reward.dtype)[:, None], rsum[:, None]], 1)
    nb = -(-B // tile)
    q = torch.cat([q, q.new_zeros(nb * tile - B, n + 2)]).view(nb, tile,
                                                               n + 2)
    p = _butterfly(q)
    if nb == 1:
        return p[0]
    c = -(-nb // 32)
    lanes = q.new_zeros(1, 32, n + 2)
    for lane in range(32):
        for b in range(lane * c, min(nb, (lane + 1) * c)):
            lanes[0, lane] = p[b] if b == lane * c else lanes[0, lane] + p[b]
    return _butterfly(lanes)[0]


def _butterfly(q):
    """``q`` (..., lanes, k) summed over the lanes by ``q += q[lane ^ h]``,
    ``h`` from half the lanes down to 1; the sum every lane holds."""
    lane = torch.arange(q.shape[-2])
    h = q.shape[-2] // 2
    while h:
        q = q + q[..., lane ^ h, :]
        h //= 2
    return q[..., 0, :]


def _thread_elements(rows, row_dim):
    """(row, column) of each element the kernel's threads visit, in the
    kernel's stepping: one division per thread, then fixed increments over
    its PER slots (the launch's rows * row_dim over the threads, rounded up
    to a power of two)."""
    dq, dc = THREADS // row_dim, THREADS % row_dim
    need = -(-min(rows, TILE) * row_dim // THREADS)
    per = next(p for p in (1, 2, 4, 8, 16) if p >= need)
    assert rows * row_dim <= per * THREADS <= TILE * MAX_ROW
    out = []
    for t in range(THREADS):
        r, c = divmod(t, row_dim)
        for _ in range(per):
            if r < rows:
                out.append((r, c))
            c += dc
            r += dq
            if c >= row_dim:
                c -= row_dim
                r += 1
    return out


def _emulated_write(ring, ptr, rows_packed):
    """The kernel's tile indexing over a flat ring: tile by tile, the
    run's first slot and the wrap row, then every element at
    ``first * row_dim + e`` (less ``cap * row_dim`` past the wrap)."""
    cap, rd = ring.shape
    flat = ring.view(-1)
    B = rows_packed.shape[0]
    for r0 in range(0, B, TILE):
        rows = min(TILE, B - r0)
        start = ptr + r0
        first = start if start < cap else start - cap
        wrap_r = cap - first
        e = torch.arange(rows * rd)
        r = e // rd
        dst = first * rd + torch.where(r >= wrap_r, e - cap * rd, e)
        flat[dst] = rows_packed[r0:r0 + rows].reshape(-1)


def _tick(rng, B, dims):
    obs_d, act_d = dims
    n = len(obs_d)
    obs = tuple(rng.normal(size=(B, d)).astype(np.float32) for d in obs_d)
    nxt = tuple(rng.normal(size=(B, d)).astype(np.float32) for d in obs_d)
    act = rng.uniform(-1, 1, (B, sum(act_d))).astype(np.float32)
    rwd = rng.uniform(-1, 1, (B, n)).astype(np.float32)
    done = rng.uniform(size=(B, n)) < 0.2
    reset = rng.uniform(size=B) < 0.3
    ep = rng.normal(size=(B, n)).astype(np.float32)
    return obs, act, rwd, nxt, done, reset, ep


@pytest.mark.parametrize("row_dim", [45, 52, 1, 64, 65, 127, 128])
@pytest.mark.parametrize("rows", [1, 5, 6, 31, 32])
def test_threads_visit_every_element_once(row_dim, rows):
    got = _thread_elements(rows, row_dim)
    assert sorted(got) == [(r, c) for r in range(rows) for c in range(row_dim)]


@pytest.mark.parametrize("framework", ["MODUL", "MONO"])
@pytest.mark.parametrize("B", [1, 31, 32, 33, 4096])
def test_emulated_order_vs_twin_and_jax(framework, B):
    """At ``ptr = cap - 3`` (the rows wrap): the emulated ring write bitwise
    the plain twin's and JAX's ``insert_tick``'s; ``ep_ret`` bitwise the
    twin's and ``roll_body``'s; the emulated K8 sums within 1e-5 max(1,
    max |sum|) of both, the count exact."""
    dims = DIMS[framework]
    n = len(dims[0])
    rng = np.random.default_rng(B + n)
    obs, act, rwd, nxt, done, reset, ep0 = _tick(rng, B, dims)
    cap = B + 5
    ptr = cap - 3
    t = torch.from_numpy
    tobs, tnxt = tuple(map(t, obs)), tuple(map(t, nxt))
    packed = kreplay.pack_rows(tobs, t(act), t(rwd), tnxt, t(done),
                               torch.float32)
    ring0 = torch.from_numpy(rng.normal(size=(cap, packed.shape[1]))
                             .astype(np.float32))

    ring_e = ring0.clone()
    _emulated_write(ring_e, ptr, packed)
    stats0 = torch.from_numpy(rng.normal(size=n + 2).astype(np.float32))
    sums_e = k8_order_sums(t(rwd), t(reset), t(ep0))
    ep_e = torch.where(t(reset)[:, None], 0.0, t(ep0) + t(rwd))

    ring_p, ep_p, stats_p = ring0.clone(), t(ep0).clone(), stats0.clone()
    kreplay.replay_insert_tick_plain(ring_p, ptr, dims, tobs, t(act), t(rwd),
                                     tnxt, t(done), t(reset), ep_p, stats_p)
    assert torch.equal(ring_e, ring_p)
    assert torch.equal(ep_e, ep_p)
    tol = 1e-5 * max(1.0, float(stats_p.abs().max()))
    assert float((stats0 + sums_e - stats_p).abs().max()) <= tol
    assert float(sums_e[n]) == float(reset.sum())

    jrs = jreplay.create(cap, *dims)
    jrs = jrs.replace(data=jnp.asarray(ring0.numpy()), ptr=jnp.int32(ptr))
    jrs = jreplay.insert_tick(jrs, tuple(map(jnp.asarray, obs)),
                              jnp.asarray(act), jnp.asarray(rwd),
                              tuple(map(jnp.asarray, nxt)), jnp.asarray(done))
    np.testing.assert_array_equal(ring_e.numpy(), np.asarray(jrs.data))

    @jax.jit
    def roll_body_stats(ep, reward, reset):
        ep = ep + reward
        fin = jnp.sum(jnp.where(reset[:, None], ep, 0.0), axis=0)
        cnt = jnp.sum(reset.astype(jnp.float32))
        rsum = reward.sum()
        return jnp.where(reset[:, None], 0.0, ep), fin, cnt, rsum
    j_ep, j_fin, j_cnt, j_rsum = roll_body_stats(
        jnp.asarray(ep0), jnp.asarray(rwd), jnp.asarray(reset))
    np.testing.assert_array_equal(ep_e.numpy(), np.asarray(j_ep))
    ref = np.concatenate([np.asarray(j_fin), [float(j_cnt), float(j_rsum)]])
    tol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(sums_e.numpy() - ref).max()) <= tol
    assert float(sums_e[n]) == float(j_cnt)


def test_order_is_fixed():
    """The emulated sums repeat bit for bit and agree with the tiles' sums
    added one after another in tile order."""
    rng = np.random.default_rng(9)
    rwd = torch.from_numpy(rng.uniform(-1, 1, (4096, 2)).astype(np.float32))
    reset = torch.from_numpy(rng.uniform(size=4096) < 0.3)
    ep = torch.from_numpy(rng.normal(size=(4096, 2)).astype(np.float32))
    a = k8_order_sums(rwd, reset, ep)
    assert torch.equal(a, k8_order_sums(rwd, reset, ep))
    tiles = (torch.where(reset[:, None], ep + rwd, 0.0)).view(128, 32, 2)
    p = tiles.sum(1)
    s = p[0]
    for b in range(1, 128):
        s = s + p[b]
    assert float((a[:2] - s).abs().max()) <= 1e-5 * float(s.abs().max())


@pytest.mark.parametrize("framework", ["MODUL", "MONO"])
def test_column_setup_matches_column_map(framework):
    """The kernel's per-column setup (each column's field found from the
    seven field widths the launch passes, in ring order) gives
    ``column_map``'s field and source column for every ring column."""
    obs_d, act_d = DIMS[framework]
    n = len(obs_d)
    o1 = obs_d[1] if n == 2 else 0
    widths = [obs_d[0], o1, sum(act_d), n, obs_d[0], o1, n]
    got = []
    for c in range(sum(widths)):
        start = 0
        for j, w in enumerate(widths):
            if start <= c < start + w:
                got.append(j << 8 | (c - start))
            start += w
    assert got == kreplay.column_map((obs_d, act_d)).tolist()
