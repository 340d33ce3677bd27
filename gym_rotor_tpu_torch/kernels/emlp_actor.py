"""K3 (forward, actor widths): the fused deterministic EMLP actor, K9: the
fused SAC actor's acting sample, and K11: the fused PPO actor's acting draw
and log-prob; one CUDA launch per agent per tick.

K3 replaces ``gym_rotor_tpu/models/emlp/nn.py:EMLPBlock`` (``EquivLinear``
-> ``EquivBiLinear`` -> ``GatedNonlinearity``) inside ``EMLP`` and the tanh
head of ``models/emlp/zoo.py:EMLPActorDet``; K9 the same trunk under
``zoo.py:EMLPActorSAC``'s Gaussian head and the squashed sample of
``algos/sac.py:114`` ``choose_action_f`` (``tanh(mean + exp(log_std)
noise)``, or ``tanh(mean)`` in eval mode; the log-prob, which the acting
path discards, is not computed); K11 the same trunk under
``zoo.py:EMLPActorPPO``'s tanh mean and free ``log_std`` with the clipped
draw of ``algos/ppo.py:107-116`` ``choose_action_f`` and the per-dimension
log-prob of the clipped action (``models/mlp.py:173``), written in place
into the horizon's log-prob columns (eval mode: ``clip(mean)`` and zeros).
XLA fused all three on the TPU.  Kernel: ``csrc/emlp_actor.cu`` (one block
body, the head a template parameter).  Plain twins: ``emlp_actor_plain``,
``sac_actor_plain`` and ``ppo_actor_plain`` (the structured ports of the
flax networks), which are what run on CPU tensors.

K11's head (``csrc/ppo_head.cuh``) is also the epilogue of the MLP PPO
actor's kernel (``kernels/mlp_ppo_actor.py``); ``ppo_head_plain``, the
head on a pre-tanh mean, is that kernel's twin's head.  SAC's MLP actor
has its own fused kernel (``kernels/mlp_sac_actor.py``, with the SAC head
of ``csrc/sac_head.cuh``).

What bounds it on an H100: the operations, and few of them.  Per row and
block the linear layer is ``2 ng nin`` flops and the bilinear layer three
per nonzero of its quadratic form (``bilinear_sparse``: 288 for agent 0's
18 gated channels, where a dense ``ng^3`` form would hold 5832), so agent 0
at B = 4096 is ~13 MFLOP against ~0.3 MB of obs/actions: ~0.2 us at the
fp32 peak.  The paths launch it at 4096, 32, 10 and 1 rows, so what holds
it is one row's chain of steps.  Design (``csrc/emlp_actor.cu``): a
32-row tile on a warp's lanes and one row's work split over the block's
warps (each warp 4 linear outputs, then its share of the bilinear
outputs by ``bilinear_plan``), the tile's vectors in shared memory, the
folded weights (``W_eff``, ``b_eff`` from ``project_linear``, K5; the
nonzeros; the gates; the head) one image (``fold_actor``) that each block
copies to shared memory.  No cuBLAS call: every product of the actor is in
the kernel body.

Actors of other dims (a config's ``actor_hidden_dim``) run
``emlp_actor_any_kernel`` (wrappers ``emlp_actor_any``, ``sac_actor_any``,
``ppo_actor_any``): the same steps with the sizes as arguments, 4-32 warps
a 32-row tile (``rt_warps``), each bilinear form in index-fixed segments
of at most ``RT_SEG`` nonzeros dealt to the warps (``rt_plan``), each
output's segments added in order, at few rows a tile's segments spread
over a cluster of ``RT_CLUSTER`` blocks; the image copied to
shared memory where it fits and read from global memory where not, the
tile's vectors in a global scratch where even they do not fit
(``any_plan``), and past 1986 gated channels the image's nonzeros as
coordinates (``ent_scale``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from ..models.emlp.nn import (bilinear_index, bilinear_sparse,
                               gate_indices, gated)
from ..models.mlp import gaussian_logprob, sac_sample_with_noise
from .build import KernelSource, check
from .emlp_block import SMEM_LIMIT

KERNEL = KernelSource("emlp_actor", [])
WRAPPERS = {"emlp_actor": "emlp_actor_plain", "sac_actor": "sac_actor_plain",
            "ppo_actor": "ppo_actor_plain", "emlp_actor_any": "emlp_actor_plain",
            "sac_actor_any": "sac_actor_plain",
            "ppo_actor_any": "ppo_actor_plain"}
HEAD_TANH, HEAD_GAUSS, HEAD_PPO = 0, 1, 2
# Per head, the (obs dim, gated width, hidden width, action dim) of the
# built instances: the flagship MODUL actors (agents 0 and 1) and the MONO
# actor, for every head.
_BUILT = {(15, 18, 16, 4), (3, 7, 4, 1), (23, 18, 16, 4)}
INSTANCES = {HEAD_TANH: _BUILT, HEAD_GAUSS: _BUILT, HEAD_PPO: _BUILT}


# The kernel's geometry (csrc/emlp_actor.cu): rows a tile (a warp's lanes),
# the field-major tiles' pitch; the image's meta: per network block b at
# 7 b the offsets of BLOCK_SECTIONS, then HEAD_SECTIONS, the image's length
# and the warps a block
TILE, PITCH = 32, 33
BLOCK_SECTIONS = ("wt", "b", "gate", "wptr", "task", "tptr", "ent")
HEAD_SECTIONS = ("wh", "bh", "wl", "bl", "log_std")
META = ([f"{n}{b}" for b in (0, 1) for n in BLOCK_SECTIONS]
        + list(HEAD_SECTIONS) + ["words", "warps"])
# a plan's cost of one output beyond its nonzeros (its epilogue), in
# nonzeros
TASK_COST = 2


def _lib():
    lib = KERNEL.load()
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.emlp_actor_launch.argtypes = [P, I, P, P, P, I, P, I, P, I, F,
                                          I, I, I, I, I, P]
        lib.emlp_actor_launch.restype = I
        lib.emlp_actor_geometry.argtypes = [I]
        lib.emlp_actor_geometry.restype = I
        lib.emlp_actor_smem.argtypes = [I, I, I, I, P]
        lib.emlp_actor_smem.restype = ctypes.c_longlong
        lib.emlp_actor_any_launch.argtypes = [P, I, P, P, P, I, P, I, P, I,
                                              F, I, I, I, I, I, I, I, P, I,
                                              P, I, I, I, P, I, P]
        lib.emlp_actor_any_launch.restype = I
        geo = [lib.emlp_actor_geometry(k) for k in range(3)]
        if geo != [TILE, PITCH, len(META)]:
            raise RuntimeError(f"emlp_actor: kernel geometry {geo} differs "
                               "from the wrapper's")
        lib._typed = True
    return lib


def actor_warps(ng: int) -> int:
    """Warps a block of the kernel at gated width ``ng``."""
    return 8 if ng > 8 else 4


def _round4(n: int) -> int:
    return (n + 3) & ~3


def head_kind(actor) -> int:
    """The head an actor's fold carries: HEAD_GAUSS for ``EMLPActorSAC``
    (its ``log_std_linear``), HEAD_PPO for ``EMLPActorPPO`` (its
    ``log_std`` parameter), else HEAD_TANH."""
    if getattr(actor, "log_std_linear", None) is not None:
        return HEAD_GAUSS
    if isinstance(getattr(actor, "log_std", None), torch.nn.Parameter):
        return HEAD_PPO
    return HEAD_TANH


def bilinear_plan(rowptr, warps: int):
    """The warps' shares of one block's bilinear form, ``(wptr, task,
    tptr, perm)``: the outputs, longest first (ties: the lower coordinate),
    each go to the warp with the least work so far (nonzeros plus
    ``TASK_COST`` an output; ties: the lower warp); warp ``w`` computes the
    outputs ``task[wptr[w]:wptr[w + 1]]``, its own in coordinate order.
    The nonzeros are repacked in that order, each output's in its own order:
    output ``task[m]``'s are the repacked ``tptr[m]:tptr[m + 1]``, the
    original entries ``perm[tptr[m]:tptr[m + 1]]``.  Every output coordinate
    is one task, also one without nonzeros (its pre is its lin)."""
    rowptr = np.asarray(rowptr, np.int64)
    nnz = np.diff(rowptr)
    ng = len(nnz)
    load, mine = [0] * warps, [[] for _ in range(warps)]
    for o in sorted(range(ng), key=lambda o: (-nnz[o], o)):
        w = min(range(warps), key=lambda w: (load[w], w))
        mine[w].append(o)
        load[w] += int(nnz[o]) + TASK_COST
    task = np.array([o for m in mine for o in sorted(m)], np.int64)
    wptr = np.cumsum([0] + [len(m) for m in mine])
    tptr = np.cumsum(np.concatenate([[0], nnz[task]]))
    perm = np.concatenate([np.arange(rowptr[o], rowptr[o + 1])
                           for o in task] + [np.zeros(0, np.int64)])
    return wptr, task, tptr, perm


def image_layout(dims, nnz, head: int) -> Dict[str, int]:
    """Word offsets of the image's sections (each a multiple of 4, so 16
    bytes aligned), by ``META``'s names; a section the head does not have
    is -1.  Per network block (``nin`` then ``nh`` inputs): ``wt``
    ``W_eff`` transposed ``(ni, round4(ng))``, zero-padded; ``b`` ``b_eff``
    ``(round4(ng),)``; ``gate`` the gate coordinates' tile offsets ``g *
    PITCH`` ``(nh,)``; the plan's ``wptr`` ``(warps + 1,)``, ``task``
    ``(ng,)`` and ``tptr`` ``(ng + 1,)``; ``ent`` the repacked nonzeros,
    two words each: ``j PITCH << 16 | i PITCH`` and v's bits.  Then the
    head's ``wh`` ``(nact, nh)`` and ``bh`` ``(nact,)``; the Gaussian
    head's log_std Dense, ``wl`` (its kernel transposed, ``(nact, nh)``)
    and ``bl``; the PPO head's ``log_std`` ``(nact,)``."""
    nin, ng, nh, nact = dims
    W, ngp = actor_warps(ng), _round4(ng)
    sizes = []
    for b, ni in enumerate((nin, nh)):
        sizes += [(f"wt{b}", ni * ngp), (f"b{b}", ngp), (f"gate{b}", nh),
                  (f"wptr{b}", W + 1), (f"task{b}", ng),
                  (f"tptr{b}", ng + 1), (f"ent{b}", 2 * nnz[b])]
    gauss, ppo = head == HEAD_GAUSS, head == HEAD_PPO
    sizes += [("wh", nact * nh), ("bh", nact),
              ("wl", nact * nh if gauss else None),
              ("bl", nact if gauss else None),
              ("log_std", nact if ppo else None)]
    out, at = {}, 0
    for name, n in sizes:
        if n is None:
            out[name] = -1
            continue
        out[name] = at
        at += _round4(n)
    out["words"], out["warps"] = at, W
    return out


def actor_smem(dims, layout) -> int:
    """Dynamic shared memory of a launch (bytes): the image and the tile's
    obs, lin, pre and h (the kernel's ``smem_of``)."""
    nin, ng, nh, _ = dims
    return 4 * layout["words"] + 4 * (nin + 2 * ng + nh) * PITCH


# Layouts forced on the run-time kernel for a check at widths that would
# not pick them (``chip_smoke.py``'s phase 26): "plan" -> ``(stage_image,
# tile_in_smem)`` over ``any_plan``'s, "ent_scale" -> 1 over
# ``ent_scale``'s, "seg" -> a segment length over ``RT_SEG`` (bump the
# actor's version to refold), "cluster" -> the blocks sharing a tile (1 or
# ``RT_CLUSTER``).  Empty in use.
_FORCE: Dict[str, object] = {}


def ent_scale(ng: int) -> int:
    """What the image's nonzero words hold for gated width ``ng``: tile
    offsets ``c * PITCH`` (scale PITCH, what the instances read) while they
    fit 16 bits, else the coordinates ``c`` (scale 1; the run-time kernel
    multiplies them by ``PITCH``)."""
    if ng > 1 << 16:
        raise ValueError(f"emlp_actor: {ng} gated channels exceed the "
                         "image's 16-bit coordinates")
    if "ent_scale" in _FORCE:
        return _FORCE["ent_scale"]
    return PITCH if (ng - 1) * PITCH < 1 << 16 else 1


# The run-time kernel's segments: at most RT_SEG nonzeros each, a
# segment's cost beyond its nonzeros in the warps' plan (its epilogue), in
# nonzeros; warps a block at most; the blocks of a cluster that share a
# tile where the tiles' clusters fit the SMs at once (few rows) and a
# network block has at least RT_CLUSTER_NNZ nonzeros (below it the cluster
# barriers cost more than the split saves: at 585 nonzeros one block a tile
# took 7.9 us and a cluster 8.6 on an H100, scripts/rt_actor_phase_probe.py)
RT_SEG, RT_SEG_COST = 256, 2
RT_MAX_WARPS = 32
RT_CLUSTER, RT_CLUSTER_NNZ = 8, 1024
RT_META = ("cseg", "wptr", "wlist", "seg", "owner")


def rt_warps(segments: int) -> int:
    """Warps a block of the run-time kernel for a block's ``segments``:
    one a segment, in powers of two from 4, at most ``RT_MAX_WARPS``."""
    w = 4
    while w < RT_MAX_WARPS and w < segments:
        w *= 2
    return w


def rt_segments(task, tptr):
    """One block's segments in output order: output ``o``'s nonzeros (the
    fold's repacked ``tptr[m]:tptr[m + 1]`` of its task ``m``) cut at
    every ``RT_SEG``-th; ``(seg, cseg)``: each segment's ``(e0, e1)`` and
    each output's first segment (``ng + 1``)."""
    ng = len(task)
    pos = np.empty(ng, np.int64)
    pos[np.asarray(task, np.int64)] = np.arange(ng)
    n = _FORCE.get("seg", RT_SEG)
    seg, cseg = [], [0]
    for o in range(ng):
        a, z = int(tptr[pos[o]]), int(tptr[pos[o] + 1])
        seg += [(e0, min(z, e0 + n)) for e0 in range(a, z, n)]
        cseg.append(len(seg))
    return seg, np.asarray(cseg, np.int64)


def rt_deal(seg, warps: int):
    """The warps' shares of the segments, ``(wptr, wlist)``: longest first
    (ties: the lower segment) to the warp with the least work so far
    (nonzeros plus ``RT_SEG_COST`` a segment; ties: the lower warp); warp
    ``w`` sums ``wlist[wptr[w]:wptr[w + 1]]``, its own in order."""
    load, mine = [0] * warps, [[] for _ in range(warps)]
    for s in sorted(range(len(seg)), key=lambda s: (seg[s][0] - seg[s][1],
                                                   s)):
        w = min(range(warps), key=lambda w: (load[w], w))
        mine[w].append(s)
        load[w] += seg[s][1] - seg[s][0] + RT_SEG_COST
    return (np.cumsum([0] + [len(m) for m in mine]),
            np.asarray([s for m in mine for s in sorted(m)], np.int64))


def rt_plan(plans, warps: int, cluster: int = 1):
    """The run-time kernel's segment plan of a fold's two network blocks
    (``plans``: each block's ``bilinear_plan``) for ``cluster`` blocks of
    ``warps`` warps sharing a tile: ``(ints, meta, slots)``, the int32
    words the kernel reads (per block ``cseg``, ``wptr`` and ``wlist``
    over the cluster's ``cluster warps`` warps, warp ``v`` the block ``v %
    cluster``'s warp ``v // cluster`` so that the longest segments spread
    over the blocks, each segment's ``(e0, e1)`` and its ``owner`` block;
    each array at a multiple of 4 words, a block whose arrays equal the
    first's pointing at the first's), their offsets ``meta`` (``RT_META``
    x block) and the larger block's segment count."""
    ints, meta, slots, at, first = [], [[0, 0] for _ in RT_META], 0, 0, None
    for b, (_, task, tptr, _) in enumerate(plans):
        seg, cseg = rt_segments(task, tptr)
        wptr, wlist = rt_deal(seg, cluster * warps)
        owner = np.zeros(len(seg), np.int64)
        for w in range(cluster * warps):
            owner[wlist[wptr[w]:wptr[w + 1]]] = w % cluster
        arrs = [np.asarray(x, np.int64).reshape(-1)
                for x in (cseg, wptr, wlist, seg, owner)]
        slots = max(slots, len(seg))
        if first is not None and all(np.array_equal(x, y)
                                     for x, y in zip(arrs, first[0])):
            for k in range(len(RT_META)):
                meta[k][b] = first[1][k]
            continue
        offs = []
        for k, arr in enumerate(arrs):
            meta[k][b] = at
            offs.append(at)
            pad = _round4(len(arr))
            ints.append(np.concatenate([arr, np.zeros(pad - len(arr),
                                                      np.int64)]))
            at += pad
        first = first or (arrs, offs)
    return np.concatenate(ints), [m for pair in meta for m in pair], slots


def any_plan(dims, layout, slots: int, plan_words: int):
    """Where the run-time kernel keeps the image, its segment plan
    (``plan_words`` ints) and the tile's vectors (obs, lin, h and
    ``slots`` segment slots): ``(stage_image, tile_in_smem, dynamic
    shared memory bytes)``: all in shared memory where they fit
    ``SMEM_LIMIT`` together, else the plan and the tile (the image read
    from global memory), else neither (the plan read from global memory,
    the tile in a global scratch, a region a block)."""
    nin, ng, nh, _ = dims
    tile = 4 * (nin + ng + nh + 2 * slots) * PITCH + 4 * plan_words
    img = 4 * layout["words"]
    if img + tile <= SMEM_LIMIT:
        return True, True, img + tile
    if tile <= SMEM_LIMIT:
        return False, True, tile
    return False, False, 0


_STRUCTURE: Dict[tuple, Dict] = {}


# an image's words: int32 for float32 parameters (what the kernel takes);
# int64 for float64 ones (the CPU tests' exact arithmetic)
_WORD = {torch.float32: torch.int32, torch.float64: torch.int64}


def _structure(actor, dims, head: int, device, dtype) -> Dict:
    """What a fold's image holds that the parameters do not change, made
    once per (reps, head, device, dtype): each block's gate coordinates and
    ``bilinear_plan``, the image's layout, and the image with those int
    sections written and zeros where the parameters go (words of
    ``dtype``'s width on ``device``), with the plans' ``perm`` there too;
    and the run-time kernel's segment plans (``rt``: per cluster size 1
    and ``RT_CLUSTER``, ``rt_plan``'s ints on ``device`` and its offsets;
    ``slots``) for ``rt_warps`` warps a block."""
    blocks = [blk for _, blk in actor.named_blocks()]
    key = (tuple((hash(b.bilinear.rep), hash(b.rep_out)) for b in blocks),
           dims, head, str(device), dtype, ent_scale(dims[1]),
           _FORCE.get("seg", RT_SEG))
    hit = _STRUCTURE.get(key)
    if hit is not None:
        return hit
    nin, ng, nh, nact = dims
    W = actor_warps(ng)
    gates, plans, nnz = [], [], []
    for blk in blocks:
        idx = bilinear_index(blk.bilinear.rep, "cpu")
        gates.append(np.asarray(gate_indices(blk.rep_out), np.int64))
        plans.append(bilinear_plan(idx["rowptr"].numpy(), W))
        nnz.append(int(idx["o"].numel()))
    layout = image_layout(dims, nnz, head)
    sc = ent_scale(ng)
    base = np.zeros(layout["words"], np.int64)
    for b, (blk, g, (wptr, task, tptr, perm)) in enumerate(
            zip(blocks, gates, plans)):
        idx = bilinear_index(blk.bilinear.rep, "cpu")
        j, i = idx["j"].numpy()[perm], idx["i"].numpy()[perm]
        for name, arr in (("gate", g * PITCH), ("wptr", wptr),
                          ("task", task), ("tptr", tptr)):
            at = layout[f"{name}{b}"]
            base[at:at + len(arr)] = arr
        at = layout[f"ent{b}"]
        base[at:at + 2 * len(perm):2] = (j * sc) << 16 | (i * sc)
    warps = rt_warps(max(len(rt_segments(task, tptr)[0])
                         for _, task, tptr, _ in plans))
    rt = {}
    for c in (1, RT_CLUSTER):
        rt_ints, rt_meta, slots = rt_plan(plans, warps, c)
        rt[c] = (torch.as_tensor(rt_ints, device=device).to(torch.int32),
                 (ctypes.c_int * len(rt_meta))(*rt_meta))
    hit = _STRUCTURE[key] = dict(
        rt=rt, slots=slots, warps=warps,
        gates=[torch.as_tensor(g, device=device) for g in gates],
        plans=plans, nnz=tuple(nnz), layout=layout, mul=PITCH // sc,
        meta=(ctypes.c_int * len(META))(*[layout[n] for n in META]),
        base=torch.as_tensor(base, device=device).to(_WORD[dtype]),
        perm=[torch.as_tensor(p, device=device) for *_, p in plans])
    return hit


def actor_dims(actor):
    """(obs dim, gated width, hidden width, action dim) of an
    ``EMLPActorDet``, ``EMLPActorSAC`` or ``EMLPActorPPO``."""
    blocks = [b for _, b in actor.named_blocks()]
    ng = gated(blocks[0].rep_out).size
    nh = blocks[0].rep_out.size
    if len(blocks) != 2 or any(gated(b.rep_out).size != ng
                               or b.rep_out.size != nh for b in blocks):
        raise NotImplementedError("emlp_actor is built for hidden_num=2 "
                                  "with one hidden rep")
    return (blocks[0].rep_in.size, ng, nh, actor.named_head()[1].rep_out.size)


def fold_actor(actor) -> Dict:
    """Folded weights for the kernel, computed once per parameter set (K5 +
    the bilinear nonzeros) and cached on the actor until its parameter
    version changes.  The key is ``actor.param_version``, an explicit
    counter that whoever writes the parameters in place bumps: the flat
    optimizer (``kernels/flat_adamw.py``) after every launch, which writes
    through a raw pointer and so leaves torch's own ``_version`` as it was.
    ``blocks`` holds, per block, ``(W_eff, b_eff, (o, j, i, v), gate
    index)``.  The kernel reads one ``image`` (int32 words, the floats'
    bits, on the actor's device; int64 words of float64 bits for a float64
    actor, which only the plain twins run) at the offsets of ``layout``
    (``image_layout``; ``meta`` the same as the C array the launcher
    takes): per block ``W_eff`` transposed and ``b_eff``, the gates, the
    warps' plan of the bilinear form and its nonzeros repacked in the
    plan's order (``plans``: per block ``bilinear_plan``'s ``(wptr, task,
    tptr, perm)``), then the head's weights (``head_kind``: the tanh head,
    the SAC actor's log_std Dense too, or the PPO actor's ``log_std``).
    The plans and the int sections depend on the reps alone and are made
    once per structure (``_structure``); each fold writes the parameters
    into a copy of that image."""
    cached = getattr(actor, "_folded", None)
    if cached is not None and cached[0] == actor.param_version:
        return cached[1]
    dims = actor_dims(actor)
    nin, ng, nh, nact = dims
    kind = head_kind(actor)
    blocks = []
    with torch.no_grad():
        for _, blk in actor.named_blocks():
            W, b = blk.linear.effective()
            blocks.append((W, b, bilinear_sparse(blk.bilinear.rep,
                                                 blk.bilinear.bi_params)))
        st = _structure(actor, dims, kind, W.device, W.dtype)
        lay = st["layout"]
        image = st["base"].clone()
        f = image.view(W.dtype)
        ngp = _round4(ng)
        for b, ((W, bias, (*_, v)), perm) in enumerate(zip(blocks,
                                                          st["perm"])):
            ni = W.shape[1]
            f[lay[f"wt{b}"]:lay[f"wt{b}"] + ni * ngp].view(
                ni, ngp)[:, :ng] = W.T
            f[lay[f"b{b}"]:lay[f"b{b}"] + ng] = bias
            at = lay[f"ent{b}"]
            f[at + 1:at + 2 * perm.numel():2] = v[perm]
        Wh, bh = actor.named_head()[1].effective()
        tail = [("wh", Wh), ("bh", bh)]
        if kind == HEAD_GAUSS:
            tail += [("wl", actor.log_std_linear.kernel.T),
                     ("bl", actor.log_std_linear.bias)]
        elif kind == HEAD_PPO:
            tail.append(("log_std", actor.log_std))
        for name, t in tail:
            f[lay[name]:lay[name] + t.numel()] = t.reshape(-1)
    folded = dict(dims=dims, head_kind=kind,
                  blocks=[(W, b, sp, g) for (W, b, sp), g
                          in zip(blocks, st["gates"])],
                  head=(Wh, bh), nnz=st["nnz"], plans=st["plans"],
                  layout=lay, meta=st["meta"], mul=st["mul"], image=image,
                  rt=st["rt"], slots=st["slots"], warps=st["warps"])
    actor._folded = (actor.param_version, folded)
    fold_actor.folds += 1
    return folded


fold_actor.folds = 0


def section(folded: Dict, name: str, n: int, ints: bool = False):
    """The first ``n`` words of the image's section ``name``
    (``image_layout``), as floats of the parameters' dtype or as ints."""
    at = folded["layout"][name]
    if at < 0:
        raise KeyError(f"the image has no section {name!r}")
    words = folded["image"][at:at + n]
    return words if ints else words.view(folded["head"][0].dtype)


def emlp_actor_plain(actor, obs):
    """Structured plain twin: tanh(EMLP(obs)) with the flax layer layout."""
    return torch.tanh(actor.network(obs))


def sac_actor_plain(actor, obs, noise: Optional[torch.Tensor] = None):
    """Structured plain twin of K9: ``EMLPActorSAC.dist`` then the squashed
    sample ``tanh(mean + exp(log_std) noise)``, or ``tanh(mean)``."""
    mean, log_std = actor.dist(obs)
    if noise is None:
        return torch.tanh(mean)
    return sac_sample_with_noise(mean, log_std, noise)[0]


def _ppo_draw(mean, log_std, noise, m: float):
    """``(clip(mean + exp(log_std) noise), gaussian_logprob of it)`` or,
    without ``noise``, ``(clip(mean), zeros)`` (ppo.py:107-116)."""
    if noise is None:
        a = torch.clamp(mean, -m, m)
        return a, torch.zeros_like(a)
    a = torch.clamp(mean + torch.exp(log_std) * noise, -m, m)
    return a, gaussian_logprob(mean, log_std, a)


def ppo_actor_plain(actor, obs, noise: Optional[torch.Tensor] = None):
    """Structured plain twin of K11: ``EMLPActorPPO.dist``, then the
    clipped draw and its log-prob, or ``(clip(mean), zeros)`` without
    ``noise``."""
    return _ppo_draw(*actor.dist(obs), noise, actor.max_action)


def _operands(actor, obs, out, noise, head: int, what: str, logp):
    """The fold and the checked operands of a launch: ``(folded, out,
    logp)`` (``out`` and, for the PPO head, ``logp`` allocated if None)."""
    folded = fold_actor(actor)
    nin, ng, nh, nact = folded["dims"]
    if folded["head_kind"] != head:
        raise ValueError(f"{what}: the actor's fold carries head "
                         f"{folded['head_kind']}, not {head}")
    B = obs.shape[0]
    if obs.dtype != torch.float32 or obs.shape != (B, nin) \
            or not obs.is_contiguous() or B == 0:
        raise ValueError(f"{what}: obs must be a contiguous float32 "
                         f"(B, {nin}) tensor with B > 0, got {obs.dtype} "
                         f"{tuple(obs.shape)}")
    if out is None:
        out = torch.empty(B, nact, dtype=torch.float32, device=obs.device)
    if head == HEAD_PPO and logp is None:
        logp = torch.empty(B, nact, dtype=torch.float32, device=obs.device)
    for name, t in (("out", out), ("logp", logp), ("noise", noise)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.shape != (B, nact) \
                or t.stride(1) != 1 or t.device != obs.device:
            raise ValueError(f"{what}: {name} must be a float32 ({B}, "
                             f"{nact}) tensor with unit column stride on "
                             f"{obs.device}")
    image = folded["image"]
    if image.device != obs.device or image.dtype != torch.int32:
        raise ValueError(f"{what}: actor weights must be float32 on the "
                         "same device as obs")
    return folded, out, logp


def _launch(actor, obs, out, noise, head: int, what: str, logp=None):
    """One launch of the actor kernel with ``head``: the instance of the
    actor's dims; returns ``(out, logp)`` (``logp`` is written by the PPO
    head only, else None).  ``any_wrapper`` (the run-time path's wrapper of
    this head) runs dims without an instance and counts that launch."""
    folded, out, logp = _operands(actor, obs, out, noise, head, what, logp)
    nin, ng, nh, nact = folded["dims"]
    lib = _lib()
    err = lib.emlp_actor_launch(
        obs.data_ptr(), obs.shape[0], folded["image"].data_ptr(),
        folded["meta"], None if noise is None else noise.data_ptr(),
        0 if noise is None else noise.stride(0), out.data_ptr(),
        out.stride(0), None if logp is None else logp.data_ptr(),
        0 if logp is None else logp.stride(0),
        getattr(actor, "max_action", 1.0), nin, ng, nh, nact, head,
        torch.cuda.current_stream(obs.device).cuda_stream)
    check(err, lib, what)
    return out, logp


_SMS: Dict[torch.device, int] = {}


def plan_words(folded) -> int:
    """The larger of a fold's segment plans' int32 words (what
    ``any_plan`` keeps room for)."""
    return max(t.numel() for t, _ in folded["rt"].values())


def _launch_any(actor, obs, out, noise, head: int, what: str, logp=None):
    """One launch of the run-time-width kernel (``emlp_actor_any_kernel``)
    with ``head``, any dims, in ``any_plan``'s layout with the fold's
    segment plan and warps: a cluster of ``RT_CLUSTER`` blocks a tile
    where the tile is in shared memory, the tiles' clusters fit the SMs at
    once and a network block has ``RT_CLUSTER_NNZ`` nonzeros, else a block
    a tile.  Returns ``(out, logp)``."""
    folded, out, logp = _operands(actor, obs, out, noise, head, what, logp)
    nin, ng, nh, nact = dims = folded["dims"]
    slots = folded["slots"]
    stage_image, tile_smem, _ = any_plan(dims, folded["layout"], slots,
                                         plan_words(folded))
    stage_image, tile_smem = _FORCE.get("plan", (stage_image, tile_smem))
    dev, B = obs.device, obs.shape[0]
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    tiles = -(-B // TILE)
    csize = RT_CLUSTER if (tile_smem and tiles * RT_CLUSTER <= _SMS[dev]
                           and max(folded["nnz"]) >= RT_CLUSTER_NNZ) else 1
    csize = _FORCE.get("cluster", csize)
    scratch, blocks = None, 0
    if not tile_smem:
        blocks = min(tiles, 2 * _SMS[dev])
        scratch = torch.empty(blocks * (nin + ng + nh + 2 * slots) * PITCH,
                              dtype=torch.float32, device=dev)
    plan, meta = folded["rt"][csize]
    lib = _lib()
    err = lib.emlp_actor_any_launch(
        obs.data_ptr(), B, folded["image"].data_ptr(), folded["meta"],
        None if noise is None else noise.data_ptr(),
        0 if noise is None else noise.stride(0), out.data_ptr(),
        out.stride(0), None if logp is None else logp.data_ptr(),
        0 if logp is None else logp.stride(0),
        getattr(actor, "max_action", 1.0), nin, ng, nh, nact, head,
        folded["mul"], int(stage_image), plan.data_ptr(), plan.numel(), meta,
        slots, folded["warps"], csize,
        None if scratch is None else scratch.data_ptr(), blocks,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, what)
    return out, logp


def _plain_into(res, out):
    if out is not None:
        out.copy_(res)
        return out
    return res


def emlp_actor(actor, obs: torch.Tensor, out: Optional[torch.Tensor] = None):
    """Actor forward.  CPU tensors -> ``emlp_actor_plain``; CUDA tensors ->
    one kernel launch (float32), or an error.  ``out`` (``(B, act_dim)``,
    unit column stride, any row stride) receives the actions in place, e.g.
    a column slice of the joint action tensor."""
    if not obs.is_cuda:
        return _plain_into(emlp_actor_plain(actor, obs), out)
    if fold_actor(actor)["dims"] not in INSTANCES[HEAD_TANH]:
        return emlp_actor_any(actor, obs, out)
    out = _launch(actor, obs, out, None, HEAD_TANH, "emlp_actor")[0]
    emlp_actor.launches += 1
    return out


emlp_actor.launches = 0


def emlp_actor_any(actor, obs: torch.Tensor,
                   out: Optional[torch.Tensor] = None):
    """``emlp_actor`` through the run-time-width kernel, what it runs for
    an actor without an instance (called directly, any actor).  CPU
    tensors -> ``emlp_actor_plain``."""
    if not obs.is_cuda:
        return _plain_into(emlp_actor_plain(actor, obs), out)
    out = _launch_any(actor, obs, out, None, HEAD_TANH, "emlp_actor_any")[0]
    emlp_actor_any.launches += 1
    return out


emlp_actor_any.launches = 0


def sac_actor(actor, obs: torch.Tensor, noise: Optional[torch.Tensor] = None,
              out: Optional[torch.Tensor] = None):
    """SAC actor's action (K9): ``tanh(mean + exp(log_std) noise)`` with the
    N(0, 1) draw ``noise`` (``(B, act_dim)``, unit column stride), or
    ``tanh(mean)`` when ``noise`` is None (eval).  CPU tensors ->
    ``sac_actor_plain``; CUDA tensors -> one kernel launch (float32), or an
    error.  ``out`` as for ``emlp_actor``."""
    if not obs.is_cuda:
        return _plain_into(sac_actor_plain(actor, obs, noise), out)
    if fold_actor(actor)["dims"] not in INSTANCES[HEAD_GAUSS]:
        return sac_actor_any(actor, obs, noise, out)
    out = _launch(actor, obs, out, noise, HEAD_GAUSS, "sac_actor")[0]
    sac_actor.launches += 1
    return out


sac_actor.launches = 0


def sac_actor_any(actor, obs: torch.Tensor,
                  noise: Optional[torch.Tensor] = None,
                  out: Optional[torch.Tensor] = None):
    """``sac_actor`` through the run-time-width kernel (K9 at any width).
    CPU tensors -> ``sac_actor_plain``."""
    if not obs.is_cuda:
        return _plain_into(sac_actor_plain(actor, obs, noise), out)
    out = _launch_any(actor, obs, out, noise, HEAD_GAUSS,
                      "sac_actor_any")[0]
    sac_actor_any.launches += 1
    return out


sac_actor_any.launches = 0


def ppo_actor(actor, obs: torch.Tensor, noise: Optional[torch.Tensor] = None,
              out: Optional[torch.Tensor] = None,
              logp: Optional[torch.Tensor] = None):
    """PPO actor's acting draw (K11): ``(action, per-dim log-prob)``, both
    ``(B, act_dim)``, with the N(0, 1) draw ``noise``, or ``(clip(mean),
    zeros)`` when ``noise`` is None (eval).  CPU tensors ->
    ``ppo_actor_plain``; CUDA tensors -> one kernel launch (float32), or an
    error.  ``out`` and ``logp`` (unit column stride, any row stride)
    receive the results in place: a column slice of the joint action and
    of the horizon's log-prob rows."""
    if not obs.is_cuda:
        a, lp = ppo_actor_plain(actor, obs, noise)
        return _plain_into(a, out), _plain_into(lp, logp)
    if fold_actor(actor)["dims"] not in INSTANCES[HEAD_PPO]:
        return ppo_actor_any(actor, obs, noise, out, logp)
    res = _launch(actor, obs, out, noise, HEAD_PPO, "ppo_actor", logp)
    ppo_actor.launches += 1
    return res


ppo_actor.launches = 0


def ppo_actor_any(actor, obs: torch.Tensor,
                  noise: Optional[torch.Tensor] = None,
                  out: Optional[torch.Tensor] = None,
                  logp: Optional[torch.Tensor] = None):
    """``ppo_actor`` through the run-time-width kernel (K11 at any width).
    CPU tensors -> ``ppo_actor_plain``."""
    if not obs.is_cuda:
        a, lp = ppo_actor_plain(actor, obs, noise)
        return _plain_into(a, out), _plain_into(lp, logp)
    res = _launch_any(actor, obs, out, noise, HEAD_PPO, "ppo_actor_any",
                      logp)
    ppo_actor_any.launches += 1
    return res


ppo_actor_any.launches = 0


def ppo_head_plain(pre, log_std, noise: Optional[torch.Tensor] = None,
                   max_action: float = 1.0):
    """K11's head on a pre-tanh mean ``pre`` (B, act) with the free
    ``log_std`` (1, act): ``mean = tanh(pre)``, then ``(clip(mean +
    exp(log_std) noise), gaussian_logprob of it)`` or, without ``noise``,
    ``(clip(mean), zeros)`` (ppo.py:107-116)."""
    mean = torch.tanh(pre)
    return _ppo_draw(mean, log_std.expand_as(mean), noise, max_action)
