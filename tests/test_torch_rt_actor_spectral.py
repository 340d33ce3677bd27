"""The run-time K7 (``spectral_iterate_any``) and the run-time acting kernel
(``emlp_actor_any``, ``sac_actor_any``, ``ppo_actor_any``) on the CPU: their
host plans and emulations of their orders of summation.

Both kernels run only on a card; here the plans they launch with are
checked (K7's cluster bands cover every row of every run-time stack the
learners hand it exactly once within a block's shared memory; the acting
kernel's segments hold every output once and every nonzero once, in its
output's order), and NumPy / torch float32 emulations of their sums are
held to the plain twins.

Tolerances.  K7's emulation against ``spectral_iterate_plain``: 1e-5 (the
kernel's tolerance against its twin); the twin against JAX's
``regularizers.py`` loop on the same stack: 1e-5.  The acting emulation
against the twins: actions 1e-5, log-probs 2e-5 max(1, max abs) (the
kernel's tolerances).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gym_rotor_tpu_torch.kernels import emlp_actor as KA
from gym_rotor_tpu_torch.kernels import spectral as KS
from gym_rotor_tpu_torch.models.emlp import nn as tnn
from gym_rotor_tpu_torch.models.emlp import zoo as tzoo
from gym_rotor_tpu_torch.utils.config import Config as TConfig

F32 = np.float32
# every stack past the instances' 128 x 128 the TD3, SAC and PPO learners
# hand K7 at critic 128 and 256 (phase 26), and critic 512's
RT_STACKS = ((3, 144, 128), (6, 144, 128), (3, 255, 128), (6, 255, 128),
             (3, 288, 256), (6, 288, 256), (3, 511, 256), (6, 511, 256),
             (3, 568, 512), (6, 568, 512), (3, 1023, 512), (6, 1023, 512))
# how many clusters the card runs at once, by cluster size: all of them;
# 16-block clusters too few for six matrices; and none of either
ACTIVE = {"all": lambda p: 64, "few16": lambda p: 3 if p.cluster == 16 else 64,
          "none": lambda p: 0}


# ---------------------------------------------------------------------------
# K7: the cluster plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("active", sorted(ACTIVE))
def test_k7_plan_bands_cover_every_row_once(active):
    """Per run-time stack, the plan's cluster bands hold every row once
    (rank r the rows [r band, (r + 1) band), the last ranks possibly
    empty), its shared memory is the kernel's formula within
    ``SMEM_LIMIT``, and it takes 16-block clusters where six of them run
    at once, 8 where they do not and an 8-block band fits."""
    for K, mo, mi in RT_STACKS:
        p = KS.any_plan(K, mo, mi, ACTIVE[active])
        rows = np.concatenate([np.arange(r * p.band, min(mo, (r + 1) * p.band))
                               for r in range(p.cluster)])
        np.testing.assert_array_equal(rows, np.arange(mo))
        assert p.cluster in KS.CLUSTER_SIZES and p.band == -(-mo // p.cluster)
        assert p.smem == KS.any_smem(mi, p.band, p.staged) <= KS.SMEM_LIMIT
        assert p.threads == (256 if mi <= 256 else 512)
        band8 = -(-mo // 8)
        fits8 = KS.any_smem(mi, band8, True) <= KS.SMEM_LIMIT
        if active == "few16" and K > 3 and fits8:
            assert (p.cluster, p.staged) == (8, True)
        else:
            assert p.cluster == 16 and p.staged


@pytest.mark.parametrize("mo, mi", ((1023, 512), (4095, 2048),
                                    (20000, 4000)))
def test_k7_plan_streams_past_the_shared_memory(mo, mi):
    """A band past a block's shared memory is read from global memory;
    only the vectors stay, within the limit; past ~19 000 columns even
    they do not fit and the plan raises."""
    p = KS.any_plan(6, mo, mi)
    assert p.smem <= KS.SMEM_LIMIT
    assert p.staged == (KS.any_smem(mi, -(-mo // 16), True) <= KS.SMEM_LIMIT)
    with pytest.raises(ValueError):
        KS.any_plan(6, mo, 20000)


# ---------------------------------------------------------------------------
# K7: the order of summation
# ---------------------------------------------------------------------------
def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(F32)


def _butterfly(a):
    """The warp's butterfly over its 32 lanes (last axis): every lane the
    same bits; lane 0's."""
    idx = np.arange(32)
    for h in (16, 8, 4, 2, 1):
        a = (a + a[..., idx ^ h]).astype(F32)
    return a[..., 0]


def _lane_dot(A, x):
    """Lane l's sum of A[..., c] x[..., c] over c = l + 32 m, one
    accumulator per m % 4, then (a0 + a1) + (a2 + a3), then the
    butterfly."""
    n = A.shape[-1]
    acc = np.zeros((4,) + np.broadcast_shapes(A.shape[:-1], x.shape[:-1])
                   + (32,), F32)
    for m in range(-(-n // 32)):
        c = np.arange(32 * m, min(n, 32 * m + 32))
        lanes = c - 32 * m
        acc[m % 4][..., lanes] = _fma(A[..., c], x[..., c],
                                      acc[m % 4][..., lanes])
    return _butterfly(((acc[0] + acc[1]) + (acc[2] + acc[3])).astype(F32))


def k7_emulate(Ws, x, cluster, iters=KS.ITERS):
    """``spectral_any_kernel``'s iterate: per block (rank) its band's row
    pass and column pass, every block's combine of the partials in rank
    order; returns ``(v, every block held the same x each iteration)``."""
    K, mo, mi = Ws.shape
    band = -(-mo // cluster)
    xs, same = x.astype(F32), True
    for _ in range(iters):
        inv = (1.0 / np.sqrt(_lane_dot(xs, xs))).astype(F32)
        parts = []
        for r in range(cluster):
            W = Ws[:, r * band:min(mo, (r + 1) * band)]
            y = _lane_dot(W, xs[:, None])                 # (K, nr)
            a = np.zeros((4, K, mi), F32)
            for q in range(W.shape[1]):
                a[q % 4] = _fma(W[:, q], y[:, q, None], a[q % 4])
            parts.append(((a[0] + a[1]) + (a[2] + a[3])).astype(F32))
        blocks = []
        for _ in range(cluster):            # each block reads its peers
            s = parts[0]
            for p in parts[1:]:
                s = (s + p).astype(F32)
            blocks.append((s * inv[:, None]).astype(F32))
        same = same and all(np.array_equal(b, blocks[0]) for b in blocks)
        xs = blocks[0]
    return (xs / np.sqrt(_lane_dot(xs, xs))[:, None]).astype(F32), same


@pytest.mark.parametrize("cluster", KS.CLUSTER_SIZES)
def test_k7_order_matches_the_twin_and_jax(cluster):
    """At a (3, 40, 24) stack (16-block bands of 3 rows, the last two
    ranks empty; 8-block bands of 5), the emulated kernel gives every
    block the same x and is within 1e-5 of ``spectral_iterate_plain``,
    which is within 1e-5 of JAX's loop (``regularizers.py:138-141``) on
    the same stack."""
    rng = np.random.default_rng(7)
    Ws = (rng.standard_normal((3, 40, 24)) / np.sqrt(24)).astype(F32)
    Ws[1, 30:] = 0.0                       # a padded, shorter matrix
    x = rng.standard_normal((3, 24)).astype(F32)
    v, same = k7_emulate(Ws, x, cluster)
    tv = KS.spectral_iterate_plain(torch.as_tensor(Ws),
                                   torch.as_tensor(x)).numpy()
    assert same
    assert np.abs(v - tv).max() <= 1e-5
    jx = jnp.asarray(x)
    for _ in range(KS.ITERS):
        y = jnp.einsum("kij,kj->ki", Ws, jx)
        jx = jnp.einsum("kij,ki->kj", Ws, y)
        jx = jx / jnp.linalg.norm(jx, axis=-1, keepdims=True)
    assert np.abs(np.asarray(jx) - tv).max() <= 1e-5


# ---------------------------------------------------------------------------
# The acting kernel: the segment plan and its order
# ---------------------------------------------------------------------------
PHASE_ACTORS = ((8, 4), (32, 8), (64, 16), (128, 32))


def _actor(ah, agent, head, seed=0):
    cfg = TConfig(actor_hidden_dim=ah)
    reps = tzoo.actor_reps(cfg, "MODUL", agent)
    gen = torch.Generator().manual_seed(seed + agent)
    if head == KA.HEAD_TANH:
        return tzoo.EMLPActorDet(*reps, device="cpu", generator=gen)
    cls = tzoo.EMLPActorSAC if head == KA.HEAD_GAUSS else tzoo.EMLPActorPPO
    actor = cls(*reps, cfg.action_dim_n[agent], device="cpu", generator=gen)
    if head == KA.HEAD_PPO:
        with torch.no_grad():
            actor.log_std.fill_(0.3)
        actor.bump_version()
    return actor


def _rt_arrays(f, b, cluster=1):
    """Block ``b``'s ``(cseg, wptr, wlist, seg, owner)`` from a fold's plan
    ints for ``cluster`` blocks a tile, ``seg`` each segment's ``(e0,
    e1)``."""
    rt, meta = f["rt"][cluster][0].numpy(), list(f["rt"][cluster][1])
    ng, warps = f["dims"][1], cluster * f["warps"]
    cseg = rt[meta[b]:meta[b] + ng + 1]
    wptr = rt[meta[2 + b]:meta[2 + b] + warps + 1]
    nseg = int(cseg[-1])
    wlist = rt[meta[4 + b]:meta[4 + b] + nseg]
    seg = rt[meta[6 + b]:meta[6 + b] + 2 * nseg].reshape(nseg, 2)
    owner = rt[meta[8 + b]:meta[8 + b] + nseg]
    return cseg, wptr, wlist, seg, owner


@pytest.mark.parametrize("agent", (0, 1))
@pytest.mark.parametrize("ah", PHASE_ACTORS, ids=str)
def test_rt_actor_plan_holds_each_output_and_nonzero_once(ah, agent):
    """Per phase-26 actor and head: the warps ``rt_warps`` gives; per
    network block each output's slots (``cseg``) hold its nonzeros once,
    in its own order (the fold's ``perm`` over them is the output's
    ``rowptr`` range), in runs of at most ``RT_SEG`` cut at every
    ``RT_SEG``-th; in the plans for one block a tile and for
    ``RT_CLUSTER``, every slot is one warp's, each warp's in order, and its
    owner the block of that warp; and ``any_plan`` keeps what it stages
    within a block's shared memory."""
    for head in (KA.HEAD_TANH, KA.HEAD_GAUSS, KA.HEAD_PPO):
        actor = _actor(ah, agent, head)
        f = KA.fold_actor(actor)
        nin, ng, nh, _ = dims = f["dims"]
        assert f["warps"] == KA.rt_warps(f["slots"])
        assert 4 <= f["warps"] <= KA.RT_MAX_WARPS
        for b, (_, blk) in enumerate(actor.named_blocks()):
            rowptr = tnn.bilinear_index(blk.bilinear.rep, "cpu")[
                "rowptr"].numpy()
            _, task, tptr, perm = f["plans"][b]
            cseg, _, _, seg, _ = _rt_arrays(f, b)
            assert cseg[0] == 0 and np.all(np.diff(cseg) >= 0)
            assert len(seg) <= f["slots"]
            for o in range(ng):
                runs = seg[cseg[o]:cseg[o + 1]]
                ents = np.concatenate([np.arange(a, z) for a, z in runs]
                                      + [np.zeros(0, np.int64)])
                np.testing.assert_array_equal(
                    perm[ents], np.arange(rowptr[o], rowptr[o + 1]))
                assert all(0 < z - a <= KA.RT_SEG for a, z in runs)
                assert all((a - runs[0][0]) % KA.RT_SEG == 0
                           for a, _ in runs)
            for c in (1, KA.RT_CLUSTER):
                cs_, wptr, wlist, sg, owner = _rt_arrays(f, b, c)
                np.testing.assert_array_equal(cs_, cseg)
                np.testing.assert_array_equal(sg, seg)
                assert sorted(wlist) == list(range(len(seg)))
                assert wptr[0] == 0 and wptr[-1] == len(seg)
                for w in range(c * f["warps"]):
                    mine = wlist[wptr[w]:wptr[w + 1]]
                    assert list(mine) == sorted(mine)
                    assert np.all(owner[mine] == w % c)
        stage_image, tile_smem, smem = KA.any_plan(
            dims, f["layout"], f["slots"], KA.plan_words(f))
        tile = 4 * (nin + ng + nh + 2 * f["slots"]) * KA.PITCH \
            + 4 * KA.plan_words(f)
        assert smem <= KA.SMEM_LIMIT and tile_smem == (tile <= KA.SMEM_LIMIT)


def rt_emulate(f, obs, head, noise=None, max_action=1.0):
    """``(action, log-prob)`` as ``emlp_actor_any_kernel`` computes them
    from the fold: each lin output's terms in input order then the bias;
    each segment's nonzeros v lin_j lin_i in order; an output's slots
    added in order, pre = 0.1 q + lin; the gate
    from pre; the head's dot products in order (the instances')."""
    nin, ng, nh, nact = f["dims"]
    P, ngp = KA.PITCH, -(-ng // 4) * 4
    x = obs.to(torch.float32)
    rows = x.shape[0]
    for b, ni in enumerate((nin, nh)):
        Wt = KA.section(f, f"wt{b}", ni * ngp).view(ni, ngp)
        lin = x.new_zeros(rows, ngp)
        for k in range(ni):
            lin = lin + x[:, k:k + 1] * Wt[k]
        lin = (lin + KA.section(f, f"b{b}", ngp))[:, :ng]
        cseg, _, _, seg, _ = _rt_arrays(f, b)
        ent = KA.section(f, f"ent{b}", 2 * f["nnz"][b], True)
        off, v = ent[0::2].numpy(), ent.view(torch.float32)[1::2]
        slot = x.new_zeros(len(seg), rows)
        for s, (a, z) in enumerate(seg):
            q = x.new_zeros(rows)
            for e in range(a, z):
                j, i = (off[e] >> 16) // P, (off[e] & 0xFFFF) // P
                q = q + v[e] * lin[:, j] * lin[:, i]
            slot[s] = q
        pre = lin.clone()
        for o in range(ng):
            if cseg[o] < cseg[o + 1]:
                pre[:, o] = 0.1 * slot[cseg[o]:cseg[o + 1]].sum(0) + lin[:, o]
        gate = torch.as_tensor(KA.section(f, f"gate{b}", nh, True).numpy()
                               // P)
        x = pre[:, :nh] / (1.0 + torch.exp(-pre[:, gate]))
    h = x
    mean = h @ KA.section(f, "wh", nact * nh).view(nact, nh).T \
        + KA.section(f, "bh", nact)
    logp = torch.zeros_like(mean)
    if head == KA.HEAD_PPO:
        mu = torch.tanh(mean)
        if noise is None:
            return torch.clamp(mu, -max_action, max_action), logp
        ls = KA.section(f, "log_std", nact)
        a = torch.clamp(mu + torch.exp(ls) * noise, -max_action, max_action)
        z = (a - mu) / torch.exp(ls)
        return a, -0.5 * z * z - ls - 0.5 * np.log(2 * np.pi)
    if head == KA.HEAD_GAUSS and noise is not None:
        ls = torch.clamp(h @ KA.section(f, "wl", nact * nh).view(nact, nh).T
                         + KA.section(f, "bl", nact), -20.0, 2.0)
        mean = mean + torch.exp(ls) * noise
    return torch.tanh(mean), logp


@pytest.mark.parametrize("head", (KA.HEAD_TANH, KA.HEAD_GAUSS, KA.HEAD_PPO))
@pytest.mark.parametrize("ah, agent", (((32, 8), 0), ((64, 16), 1)))
def test_rt_actor_order_matches_the_twins(ah, agent, head):
    """The emulated run-time kernel (its segments) against the plain twins
    at 37 rows, with the draws and without (eval)."""
    actor = _actor(ah, agent, head)
    f = KA.fold_actor(actor)
    rng = np.random.default_rng(3)
    obs = torch.as_tensor(rng.standard_normal((37, f["dims"][0])),
                          dtype=torch.float32)
    draws = torch.as_tensor(rng.standard_normal((37, f["dims"][3])),
                            dtype=torch.float32)
    for noise in ((None,) if head == KA.HEAD_TANH else (draws, None)):
        ka, kl = rt_emulate(f, obs, head, noise, actor.max_action
                            if head == KA.HEAD_PPO else 1.0)
        with torch.no_grad():
            if head == KA.HEAD_TANH:
                pa, pl = KA.emlp_actor_plain(actor, obs), torch.zeros_like(ka)
            elif head == KA.HEAD_GAUSS:
                pa, pl = KA.sac_actor_plain(actor, obs, noise), \
                    torch.zeros_like(ka)
            else:
                pa, pl = KA.ppo_actor_plain(actor, obs, noise)
        assert float((ka - pa).abs().max()) <= 1e-5
        assert float((kl - pl).abs().max()) <= 2e-5 * max(
            1.0, float(pl.abs().max()))


def test_rt_actor_segments_split_long_outputs():
    """Segments of 16 nonzeros (``_FORCE["seg"]``, what outputs past
    ``RT_SEG`` nonzeros take) at the (32, 8) actor: each output's slots
    tile its nonzeros in order, and the emulated kernel, which adds them in
    order, stays within the twins' tolerance."""
    actor = _actor((32, 8), 0, KA.HEAD_PPO)
    KA._FORCE["seg"] = 16
    try:
        actor.bump_version()
        f = KA.fold_actor(actor)
    finally:
        KA._FORCE.pop("seg")
        actor.bump_version()
    for b in (0, 1):
        cseg, _, wlist, seg, _ = _rt_arrays(f, b)
        assert np.diff(cseg).max() > 1 and np.all(seg[:, 1] - seg[:, 0]
                                                  <= 16)
        assert sorted(wlist) == list(range(len(seg)))
        _, task, tptr, _ = f["plans"][b]
        for m, o in enumerate(task):
            runs = seg[cseg[o]:cseg[o + 1]]
            assert runs[0][0] == tptr[m] and runs[-1][1] == tptr[m + 1]
            np.testing.assert_array_equal(runs[1:, 0], runs[:-1, 1])
    rng = np.random.default_rng(5)
    obs = torch.as_tensor(rng.standard_normal((20, 15)), dtype=torch.float32)
    noise = torch.as_tensor(rng.standard_normal((20, 4)), dtype=torch.float32)
    ka, kl = rt_emulate(f, obs, KA.HEAD_PPO, noise, actor.max_action)
    with torch.no_grad():
        pa, pl = KA.ppo_actor_plain(actor, obs, noise)
    assert float((ka - pa).abs().max()) <= 1e-5
    assert float((kl - pl).abs().max()) <= 2e-5 * max(1.0, float(
        pl.abs().max()))
