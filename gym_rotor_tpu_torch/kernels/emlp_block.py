"""K3 (forward, training widths) and K4 (backward): one EMLP block,
``lin = x W_effᵀ + b_eff``, ``pre = 0.1 Q(lin) + lin``, ``h = gate(pre)``,
under autograd.

Replaces ``gym_rotor_tpu/models/emlp/nn.py:431`` ``EMLPBlock``
(``EquivLinear`` -> ``EquivBiLinear`` -> ``GatedNonlinearity``) and its
autodiff through ``fixed_gather``'s custom VJP (``nn.py:39-81``), which XLA
fused on the TPU.  Kernels: ``csrc/emlp_block.cu``.  Plain twins:
``emlp_block_plain`` and ``emlp_block_backward_plain``, which are what run
on CPU tensors and repeat the kernels' arithmetic.

``Q`` is the block's bilinear form as its nonzeros (``bilinear_sparse``):
``Q(lin)[o] = sum_e v[e] lin[j[e]] lin[i[e]]`` over the entries of output
``o``.  The forward saves ``lin`` and ``pre`` (field-major, ``(ng, B)``)
only when a backward will read them: ``block_apply`` runs it without them
when autograd records nothing (``torch.no_grad()``, or no input needing a
gradient), as JAX under ``jit`` keeps no residual it does not need.  The
backward of a nonzero ``(o, j, i, v)`` is
``g_lin[j] += 0.1 v g_pre[o] lin[i]``, ``g_lin[i] += 0.1 v g_pre[o] lin[j]``
and ``g_v[e] = sum over rows of 0.1 g_pre[o] lin[j] lin[i]``; the gate's
two terms land on one coordinate where ``gate_idx[c] == c`` (SiLU).  The
kernel takes ``g_lin`` as a gather: ``BlockSpec`` holds, per coordinate,
the nonzeros that touch it (``coordinate_lists``) and the gate's inverse,
and ``backward_plan`` cuts the coordinates into groups (one per block
column of the grid) and the lists into segments dealt to the warps.  The
sums over rows of ``g_W``, ``g_b`` and ``g_v`` are per-tile partials and a
second pass, in a fixed order, so a run repeats its numbers.  Gradients
reach the raw ``kernel``/``bias`` through ``project_linear`` (K5, torch
autograd) and ``bi_params`` through ``bilinear_sparse``'s ``index_add_``.

What bounds it on an H100: the operations, and few.  Agent 1's critic
block 1 (123 gated channels, 9394 nonzeros) at B = 256 is ~11 MFLOP
forward, ~0.17 us at the fp32 peak; the latency of the sparse gathers
dominates, so the kernels put a tile's 32 rows on a warp's lanes and the
index on the warps (``csrc/emlp_block.cu`` describes the layout).

The kernels above are template instances (``INSTANCES``), each staging a
block's whole ``W_eff`` and its tiles in shared memory.  A block of any
other ``(nin, ng, nh)`` (a config's ``critic_hidden_dim`` or
``actor_hidden_dim``) runs the run-time-width kernels instead
(``emlp_block_any``, ``emlp_block_backward_any``): the sizes as
arguments, one launch a step with the vectors between steps field-major
in global memory.  The dense steps are register-tiled products; the
sparse steps stage the tile in shared memory at ``R`` rows a lane and
stream the index through a per-warp ring; the parameter sums are taken
per 32-row tile and added into ``RT_SLOTS`` slots, tile ``k`` into slot
``k % 8``, then the slots in order (``csrc/emlp_block.cu`` describes the
design).  ``BlockSpec.rt_ints`` is their index, ``rt_words`` the packed
offsets the sparse steps stream, ``rt_layout`` and ``rt_plan`` their
plan.  Their sums are taken in the instances' orders except g_lin's,
which sums each coordinate's list in one run (the instances cut it into
segments): the forward and g_v are an instance's bit for bit, g_lin and
what is summed from it (g_x, g_W, g_b) agree with an instance's to the
twins' tolerance.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..models.emlp.nn import (bilinear_index, bilinear_sparse, gate_indices,
                               merge_nonzeros, project_linear)
from .build import KernelSource, check

KERNEL = KernelSource("emlp_block", [])
WRAPPERS = {"emlp_block": "emlp_block_plain",
            "emlp_block_backward": "emlp_block_backward_plain",
            "emlp_block_any": "emlp_block_plain",
            "emlp_block_backward_any": "emlp_block_backward_plain"}
# (nin, ng, nh) of the built instances: both blocks of the flagship MODUL
# twin Q critics (hidden 62), the first blocks of the PPO V critics (obs in;
# their hidden blocks are the Q critics'), the actors (hidden 16 / 4), the
# first blocks of the MONO twin Q critic (27 = 23 obs + 4 actions in) and
# actor (23 obs in; their hidden blocks are MODUL agent 0's), and the first
# blocks of the CTDE critics over the joint input (Q: 23 = 18 obs + 5
# actions, V: 18 obs; SO2eR3 tower for agent 0, Mirror for agent 1), the
# 23-wide SO2eR3 one also the MONO V critic's.
INSTANCES = {(19, 71, 62), (62, 71, 62), (4, 123, 62), (62, 123, 62),
             (15, 71, 62), (3, 123, 62),
             (15, 18, 16), (16, 18, 16), (3, 7, 4), (4, 7, 4),
             (27, 71, 62), (23, 18, 16),
             (23, 71, 62), (23, 123, 62), (18, 71, 62), (18, 123, 62)}
# The kernels' geometry (csrc/emlp_block.cu): rows per tile (a warp's
# lanes), the field-major tiles' pitch, the warps of a forward and of a
# backward block
TILE, PITCH, FWD_WARPS, BWD_WARPS = 32, 33, 16, 16
# The plans: the backward's grid about BLOCKS_PER_SM blocks an SM, the
# forward's groups only as many as fill idle SMs (its launcher makes a
# persistent grid of as many blocks as fit on the SMs); a forward group
# holds at least FWD_WARPS * 32 nonzeros, a backward group at least BWD_WARPS *
# GROUP_MIN_ENTRIES list entries, a list segment at least SEG_MIN; a
# backward block's shared memory at most SMEM_TARGET where enough groups
# allow it (two blocks an SM), and at most SMEM_LIMIT (an H100 block's)
BLOCKS_PER_SM = 2
SEG_MIN, GROUP_MIN_ENTRIES = 16, 64
SMEM_TARGET, SMEM_LIMIT = 113 * 1024, 232448
# The run-time-width kernels (any (nin, ng, nh); csrc/emlp_block.cu
# "run-time widths"): warps a block of the sparse steps, entries a ring
# buffer and a warp's buffers, the parameter sums' slots, a dense step's
# tile side; the rings' shared memory a sparse block (bytes); a lane takes two rows from
# RT_TWO_ROWS_MIN rows where the tile fits; a block column of the sparse
# steps is planned for RT_BLOCKS_PER_SM blocks an SM at most
RT_WARPS, RT_RING, RT_RING_BUFS, RT_SLOTS, RT_GEMM_TILE = 16, 32, 4, 8, 64
RT_RING_BYTES = RT_WARPS * RT_RING_BUFS * RT_RING * 8
# the list step's segments: a coordinate's list cut into runs of at most
# RT_SEG entries (fixed by the index alone, so g_lin's order does not
# depend on the batch or the card)
RT_SEG = 256
RT_TWO_ROWS_MIN = 512
RT_BLOCKS_PER_SM = 4
SM_SMEM = 233472          # an H100 SM's shared memory (bytes)

def _lib():
    lib = KERNEL.load()
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.emlp_block_fwd_launch.argtypes = [P, I, P, P, P, P, I, P, P, P,
                                              P, P, I, I, I, P]
        lib.emlp_block_fwd_launch.restype = I
        lib.emlp_block_bwd_launch.argtypes = [P, P, I, P, P, P, I, P, P, P,
                                              P, P, P, P, P, I, I, I, I, P]
        lib.emlp_block_bwd_launch.restype = I
        lib.emlp_block_smem.argtypes = [I, I, I, P, I]
        lib.emlp_block_smem.restype = ctypes.c_longlong
        lib.emlp_block_geometry.argtypes = [I]
        lib.emlp_block_geometry.restype = I
        lib.emlp_block_rt_fwd_launch.argtypes = [P, I, P, P, P, P, I, P, P,
                                                 I, I, I, P, P, P, I, I, I,
                                                 P]
        lib.emlp_block_rt_fwd_launch.restype = I
        lib.emlp_block_rt_bwd_launch.argtypes = [P, P, I, P, P, P, I, P, P,
                                                 I, P, P, P, I, I, I, I, P,
                                                 P, P, P, P, P, I, I, I, I,
                                                 P]
        lib.emlp_block_rt_bwd_launch.restype = I
        lib.emlp_block_rt_geometry.argtypes = [I]
        lib.emlp_block_rt_geometry.restype = I
        if tuple(lib.emlp_block_geometry(k) for k in range(4)) != \
                (TILE, PITCH, FWD_WARPS, BWD_WARPS):
            raise RuntimeError("emlp_block: kernel geometry differs from "
                               "the wrapper's")
        if tuple(lib.emlp_block_rt_geometry(k) for k in range(5)) != (
                RT_WARPS * 32, RT_RING, RT_SLOTS, RT_GEMM_TILE,
                RT_RING_BYTES // 4):
            raise RuntimeError("emlp_block: run-time kernels' geometry "
                               "differs from the wrapper's")
        lib._typed = True
    return lib


def coordinate_lists(o, j, i, ng):
    """The nonzeros as coordinate-major lists: for each coordinate ``c``
    those with ``j[e] == c`` (partner ``i[e]``), then those with
    ``i[e] == c`` (partner ``j[e]``), each in ``e`` order, so a nonzero
    with ``j == i`` sits twice in its list.  Returns ``(ptr (ng + 1), e, o,
    partner)``: ``c``'s list is ``ptr[c]:ptr[c + 1]``."""
    nnz = len(o)
    e = np.concatenate([np.arange(nnz), np.arange(nnz)])
    c = np.concatenate([j, i])
    role = np.repeat([0, 1], nnz)
    srt = np.lexsort((e, role, c))
    ptr = np.searchsorted(c[srt], np.arange(ng + 1))
    partner = np.concatenate([i, j])[srt]
    return ptr, e[srt], np.asarray(o)[e[srt]], partner


def gate_inverse(gate, ng):
    """For each coordinate ``c`` the outputs ``k`` with ``gate[k] == c``,
    ascending: ``(ptr (ng + 1), k)``."""
    k = np.argsort(gate, kind="stable")
    return np.searchsorted(np.asarray(gate)[k], np.arange(ng + 1)), k


def _split(weights, groups):
    """Boundaries (groups + 1) of ``groups`` contiguous non-empty runs of
    ``weights`` of about equal sums."""
    n = len(weights)
    if not 1 <= groups <= n:
        raise ValueError(f"{groups} groups of {n} items")
    cum = np.concatenate([[0], np.cumsum(weights)])
    cb = np.concatenate([[0], np.searchsorted(
        cum, np.arange(1, groups) * cum[-1] / groups), [n]])
    for g in range(1, groups):
        cb[g] = min(max(cb[g], cb[g - 1] + 1), n - (groups - g))
    return cb


class Plan(NamedTuple):
    """One grid's split (``forward_plan``, ``backward_plan``): the int
    arrays the kernel reads, in its order, and ``meta``, the sizes its
    launcher reads on the host (csrc/emlp_block.cu ``FwdMeta``,
    ``BwdMeta``)."""
    hdr: np.ndarray     # (G, 10) per group, as the kernel's FwdHdr / BwdHdr
    arrays: tuple       # forward: (fo,); backward: (wb, seg, cs)
    meta: tuple


class RtPlan(NamedTuple):
    """A run-time step's plan (``BlockSpec.rt_plan``): the int32 tensor its
    kernel reads, its block columns, a lane's rows, whether the tile is
    staged, and (the list step) the most segments a column has."""
    ints: torch.Tensor
    cols: int
    rows: int
    staged: bool
    segs: int


def atoms(gate, nh):
    """The gated nonlinearity's atoms from its gate indices: ``(k0, k1,
    gate coordinate or None)`` for each run of outputs sharing a gate
    coordinate and each output that gates itself."""
    gate = np.asarray(gate)
    starts = [k for k in range(nh) if k == 0 or gate[k] == k
              or gate[k] != gate[k - 1]]
    return [(a, b, int(gate[a]) if gate[a] >= nh else None)
            for a, b in zip(starts, starts[1:] + [nh])]


def forward_plan(gate, rowptr, nh, groups, warps=FWD_WARPS):
    """Split the gated nonlinearity's atoms (a run of outputs sharing a
    gate coordinate, or one output gating itself) into ``groups`` runs of
    about equal nonzeros.  Group g computes pre for its outputs
    ``k0:k1`` and its gate coordinates ``q0:q1`` (contiguous: gates follow
    their atoms' order), their nonzeros being ``eh0:eh1`` and ``eq0:eq1``,
    and h for ``k0:k1``; its outputs, longest first, are ``fo[f0:f1]``."""
    ng = len(rowptr) - 1
    nnz = np.diff(rowptr)
    units = atoms(gate, nh)
    w = [nnz[a:b].sum() + (nnz[q] if q is not None else 0) + 1
         for a, b, q in units]
    ub = _split(w, groups)
    hdr, fo = [], []
    q0 = nh
    for g in range(groups):
        mine = units[ub[g]:ub[g + 1]]
        k0, k1 = mine[0][0], mine[-1][1]
        q1 = q0 + sum(q is not None for *_, q in mine)
        outs = list(range(k0, k1)) + list(range(q0, q1))
        outs.sort(key=lambda o: -nnz[o])
        hdr.append((k0, k1, q0, q1, len(fo), len(fo) + len(outs),
                    rowptr[k0], rowptr[k1], rowptr[q0], rowptr[q1]))
        fo += outs
        q0 = q1
    hdr = np.asarray(hdr)
    if q0 != ng or len(fo) != ng:
        raise ValueError("forward_plan: the gate coordinates do not follow "
                         "their atoms")
    max_ent = int(max(h[7] - h[6] + h[9] - h[8] for h in hdr))
    return Plan(hdr, (np.asarray(fo),), (groups, max_ent, warps))


def backward_plan(cl_ptr, rowptr, groups, warps=BWD_WARPS):
    """Split the coordinates into ``groups`` contiguous groups of about
    equal work (list entries, plus the group's g_v sums and one per
    coordinate), cut each list into segments of about equal length (at
    least ``SEG_MIN`` entries, about one per warp of the grid), and deal
    each group's segments to its ``warps`` warps, longest first, each to
    the least loaded one.  A segment's slot is its place among its
    coordinate's segments in list order.  Group g owns coordinates
    ``c0:c1``, list entries ``e0:e1``, slots ``s0:s1``, dealt segments
    ``seg0:seg1`` and the g_v sums of the nonzeros ``v0:v1`` (those whose
    output it owns)."""
    n = np.diff(cl_ptr)
    cb = _split(n + np.diff(rowptr) + 1, groups)
    size = max(SEG_MIN, -(-int(n.sum()) // (groups * warps)))
    n_seg = -(-n // size)
    cs = np.concatenate([[0], np.cumsum(n_seg)])
    bounds = [cl_ptr[c] + (n[c] * np.arange(k + 1)) // max(k, 1)
              for c, k in enumerate(n_seg)]
    seg, wb, hdr = [], [0], []
    for g in range(groups):
        c0, c1 = cb[g], cb[g + 1]
        mine = [(cs[c] + s, b[s], b[s + 1])
                for c, b in zip(range(c0, c1), bounds[c0:c1])
                for s in range(len(b) - 1)]
        mine.sort(key=lambda t: t[1] - t[2])          # longest first
        load, dealt = np.zeros(warps, np.int64), [[] for _ in range(warps)]
        for t in mine:
            w = int(np.argmin(load))
            load[w] += t[2] - t[1]
            dealt[w].append(t)
        seg0 = len(seg)
        for d in dealt:
            seg += d
            wb.append(len(seg))
        hdr.append((c0, c1, cl_ptr[c0], cl_ptr[c1], cs[c0], cs[c1], seg0,
                    len(seg), rowptr[c0], rowptr[c1]))
    hdr = np.asarray(hdr)
    span = hdr[:, 1::2] - hdr[:, 0::2]     # coords, entries, slots, segs, nv
    meta = (groups, len(seg), int(span[:, 1].max()), int(span[:, 2].max()),
            int(span[:, 0].max()), int(span[:, 3].max()),
            int(span[:, 4].max()), warps)
    return Plan(hdr, (np.asarray(wb), np.asarray(seg).reshape(-1, 3), cs),
                meta)


def rt_atoms(gate, nh):
    """The run-time forward's atoms ``(n_atoms, 3)``: ``(k0, k1, gate
    coordinate)`` for a run of outputs sharing a gate coordinate past
    ``nh``, ``(k, k + 1, -1)`` for an output gating itself."""
    out = []
    for k0, k1, q in atoms(gate, nh):
        if q is None and not (k1 == k0 + 1 and gate[k0] == k0):
            raise ValueError(f"emlp_block: outputs {k0}:{k1} are gated by "
                             f"output {gate[k0]}")
        out.append((k0, k1, -1 if q is None else q))
    return np.asarray(out, np.int64).reshape(-1, 3)


# A layout forced on the run-time path for a check (``chip_smoke.py``'s
# phase 26 holds the global-memory tiles and each lane's rows bitwise to
# the chosen ones): ``{"forward" | "backward": bool}`` staging over
# ``rt_stage``'s, ``{"forward_rows" | "backward_rows": 1 | 2}`` a staged
# lane's rows over ``rt_layout``'s.  Empty in use.
_FORCE: Dict[str, object] = {}


def rt_smem(dims, kind, rows, segs=0):
    """Dynamic shared memory (bytes) of the run-time path's sparse launch:
    the forward's gate step (the rings and the tile's lin) or the
    backward's list step (the rings, its g_pre and lin, and ``segs``
    segments' shares of ``32 rows`` rows), ``rows`` a lane with the tile
    staged (1 or 2: tiles of ``32 rows`` at pitch ``32 rows + 1``), 0 with
    the tile read from global memory (one row a lane).  The dense
    launches' shared memory is static."""
    tiles = 1 if kind == "forward" else 2
    return RT_RING_BYTES + (4 * tiles * dims[1] * (32 * rows + 1)
                            if rows else 0) + 4 * segs * 32 * max(rows, 1)


def rt_blocks_per_sm(smem):
    """Blocks of a sparse step an SM holds at ``smem`` dynamic bytes (an
    H100 SM's shared memory, 1 KB a block reserved, 2048 threads)."""
    return max(1, min(RT_BLOCKS_PER_SM, SM_SMEM // (smem + 1024)))


def rt_runs(weights, n):
    """Boundaries (n + 1) of ``n`` contiguous runs of ``weights`` of about
    equal sums, empty runs allowed (more runs than items)."""
    cum = np.concatenate([[0], np.cumsum(weights)])
    b = np.searchsorted(cum, np.arange(n + 1) * cum[-1] / n, side="left")
    b[0], b[-1] = 0, len(weights)
    return np.maximum.accumulate(b)


def rt_forward_plan(gate, rowptr, nh, cols):
    """The run-time gate step's plan: ``cols`` block columns, runs of whole
    atoms of about equal work (each atom's and its gate's nonzeros, and
    one); per column ``k0, k1, q0, q1`` (its outputs and its gate
    coordinates, contiguous: the gates follow their atoms), then per warp
    two runs of its coordinates ``(a0, a1, b0, b1)`` (outputs, then gate
    coordinates; each warp's coordinates contiguous, their nonzeros
    contiguous in the index) of about equal nonzeros.  An int array
    ``(cols, 4 + 4 RT_WARPS)``."""
    nnz = np.diff(rowptr)
    at = rt_atoms(gate, nh)
    w = [nnz[k0:k1].sum() + (nnz[g] if g >= 0 else 0) + 1
         for k0, k1, g in at]
    cb = _split(w, cols)
    out = []
    for a0, a1 in zip(cb[:-1], cb[1:]):
        run = at[a0:a1]
        g = run[:, 2][run[:, 2] >= 0]
        q0 = int(g[0]) if len(g) else nh
        if not np.array_equal(g, np.arange(q0, q0 + len(g))):
            raise ValueError("emlp_block: gate coordinates do not follow "
                             "their atoms")
        k0, k1, q1 = int(run[0, 0]), int(run[-1, 1]), q0 + len(g)
        nk = k1 - k0
        coords = np.concatenate([np.arange(k0, k1), np.arange(q0, q1)])
        wb = rt_runs(nnz[coords] + 1, RT_WARPS)
        row = [k0, k1, q0, q1]
        for s0, s1 in zip(wb[:-1], wb[1:]):
            row += [k0 + min(s0, nk), k0 + min(s1, nk),
                    q0 + max(s0 - nk, 0), q0 + max(s1 - nk, 0)]
        out.append(row)
    return np.asarray(out, np.int64)


def rt_segments(cl_ptr, seg_len=RT_SEG):
    """Each coordinate's list cut into ``ceil(n / seg_len)`` runs of about
    equal length, in order: ``(seg (n_seg + 1), cseg (ng + 1))``, segment
    ``s`` the list entries ``seg[s]:seg[s + 1]``, coordinate ``c``'s the
    segments ``cseg[c]:cseg[c + 1]`` (none for an empty list)."""
    n = np.diff(cl_ptr)
    k = -(-n // seg_len)
    cseg = np.concatenate([[0], np.cumsum(k)])
    starts = [cl_ptr[c] + (n[c] * np.arange(k[c])) // k[c]
              for c in range(len(n)) if k[c]]
    seg = np.concatenate(starts + [[cl_ptr[-1]]]).astype(np.int64)
    return seg, cseg


def rt_backward_plan(cl_ptr, seg, cseg, nnz, cols):
    """The run-time list step's plan: ``cols`` block columns, each a run
    of coordinates of about equal list entries (and one each) and a run of
    nonzeros ``v0:v1`` whose g_v it sums (equal runs); per column ``v0, v1,
    c0, c1, g0, g1`` (its nonzeros, coordinates and their segments), then
    per warp a run of its segments ``(sa, sb)`` of about equal entries.
    Returns the int array ``(cols, 6 + 2 RT_WARPS)`` and the most segments
    a column has."""
    n = np.diff(cl_ptr)
    cb = _split(n + 1, cols)
    vb = (nnz * np.arange(cols + 1)) // cols
    out, most = [], 0
    for k, (c0, c1) in enumerate(zip(cb[:-1], cb[1:])):
        g0, g1 = cseg[c0], cseg[c1]
        most = max(most, g1 - g0)
        wb = g0 + rt_runs(np.diff(seg[g0:g1 + 1]) + 1, RT_WARPS)
        row = [vb[k], vb[k + 1], c0, c1, g0, g1]
        for a, b in zip(wb[:-1], wb[1:]):
            row += [a, b]
        out.append(row)
    return np.asarray(out, np.int64), int(most)


def forward_smem(dims, meta):
    """Dynamic shared memory of the forward kernel under a plan
    (the layout of ``block_fwd_kernel``)."""
    nin, ng, nh = dims
    ngp = -(-ng // 4) * 4
    return 4 * nin * ngp + 8 * meta[1] + 4 * ngp + 4 * (2 * ng + 1 + nh) \
        + 4 * PITCH * (2 * nin + 2 * ng)


def backward_smem(dims, meta):
    """Dynamic shared memory of the backward's main kernel under a plan
    (the layout of ``block_bwd_kernel``)."""
    nin, ng, nh = dims
    _, _, ent, slots, coords, segs, nv, _ = meta
    return 8 * (ent + nv) + 4 * PITCH * (3 * ng + nh + nin + slots + coords) \
        + 4 * coords * (-(-nin // 4) * 4) \
        + 4 * (3 * segs + BWD_WARPS + 1 + coords + 1 + 2 * nh + ng + 1)


class BlockSpec:
    """The static side of one block: sizes, the bilinear index (int32 for
    the kernel, int64 for the plain twin), the gate indices, the
    coordinate-major lists and the gate's inverse, per device; and the
    kernels' plans and group counts, made at first use.

    ``BlockSpec(rep_in, rep_out, grep, device)`` is a scoped ``EMLPBlock``'s
    (its index from ``bilinear_index``); ``BlockSpec.from_index`` takes the
    sizes, a merged index (``nn.merge_nonzeros``) and the gate indices of
    any block, and with ``runtime_only`` (a general block,
    ``general_block_spec``) the wrappers send it to the run-time-width
    kernels whatever its sizes.  ``rows`` is None, or the order in which
    the block's gated coordinates were relabelled (``general_block_spec``):
    the caller passes ``W_eff`` and ``b_eff`` in that row order."""

    runtime_only = False
    rows = None

    def __init__(self, rep_in, rep_out, grep, device):
        self._setup((rep_in.size, grep.size, rep_out.size),
                    bilinear_index(grep, device), gate_indices(rep_out),
                    device)

    @classmethod
    def from_index(cls, dims, idx, gate, device, runtime_only=False,
                   rows=None):
        spec = cls.__new__(cls)
        spec.runtime_only, spec.rows = runtime_only, rows
        spec._setup(dims, idx, gate, device)
        return spec

    def _setup(self, dims, idx, gate, device):
        self.nin, self.ng, self.nh = dims
        self.device = torch.device(device)
        self.idx = idx
        self.nnz = int(self.idx["o"].numel())
        self.gate = np.asarray(gate)
        self.gidx = torch.as_tensor(self.gate, device=device).to(torch.int64)
        o, j, i = (self.idx[k].cpu().numpy() for k in ("o", "j", "i"))
        self.lists = coordinate_lists(o, j, i, self.ng)
        self.ginv = gate_inverse(self.gate, self.ng)
        self.rowptr = self.idx["rowptr"].cpu().numpy()
        self._plans: Dict[tuple, tuple] = {}
        if self.runtime_only:
            self.ints = None
            return
        ptr, e, lo, partner = self.lists
        # the kernels' index (csrc/emlp_block.cu ``Ints``): tile offsets
        # c * PITCH packed two to an int
        self.ints = torch.as_tensor(np.concatenate([
            self.gate, self.rowptr, self.idx["ji"].cpu().numpy(), o,
            (j * PITCH) << 16 | i * PITCH, ptr,
            (lo * PITCH) << 16 | partner * PITCH, e,
            *self.ginv]).astype(np.int32), device=device)

    @property
    def dims(self):
        return (self.nin, self.ng, self.nh)

    def groups(self, kind, B, sms):
        """The group count of ``kind``'s grid ("forward" or "backward") at
        ``B`` rows on a card of ``sms`` SMs: the forward's about one block
        an SM, the backward's about ``BLOCKS_PER_SM`` (and enough groups
        for ``SMEM_TARGET``), each group with at least its minimum of
        work."""
        key = ("groups", kind, B, sms)
        hit = self._plans.get(key)
        if hit is not None:
            return hit
        tiles = -(-B // TILE)
        if kind == "forward":
            # a tile's groups each recompute its lin: only fill idle SMs
            hit = max(1, min(sms // tiles, len(atoms(self.gate, self.nh)),
                             self.nnz // (FWD_WARPS * 32)))
        else:
            want = -(-BLOCKS_PER_SM * sms // tiles)
            g_min = next((g for g in range(1, self.ng) if backward_smem(
                self.dims, self.plan("backward", g).meta) <= SMEM_TARGET),
                self.ng)
            g_max = min(self.ng,
                        2 * self.nnz // (BWD_WARPS * GROUP_MIN_ENTRIES))
            hit = min(max(want, g_min), max(g_min, g_max))
        self._plans[key] = hit
        return hit

    def plan(self, kind, groups) -> Plan:
        """``kind``'s plan at ``groups`` groups."""
        key = (kind, groups)
        hit = self._plans.get(key)
        if hit is None:
            hit = self._plans[key] = (
                forward_plan(self.gate, self.rowptr, self.nh, groups)
                if kind == "forward"
                else backward_plan(self.lists[0], self.rowptr, groups))
        return hit

    def rt_ints(self):
        """The run-time path's index (csrc/emlp_block.cu ``RtInts``: gate,
        rowptr, each nonzero's j, i and o, each list entry's nonzero, the
        gate's inverse) as one int32 tensor on this spec's device; the
        sparse steps' entries are ``rt_words`` and ``rt_segments``."""
        hit = self._plans.get("rt_ints")
        if hit is None:
            o, j, i = (self.idx[k].cpu().numpy() for k in ("o", "j", "i"))
            flat = np.concatenate([self.gate, self.rowptr, j, i, o,
                                   self.lists[1], *self.ginv])
            hit = self._plans["rt_ints"] = torch.as_tensor(
                flat.astype(np.int32), device=self.device)
        return hit

    def rt_stage(self, kind):
        """Whether the run-time path stages ``kind``'s tiles in shared
        memory (one lane's row fits a block's limit)."""
        if kind in _FORCE:
            return bool(_FORCE[kind])
        return rt_smem(self.dims, kind, 1) <= SMEM_LIMIT

    def rt_layout(self, kind, B):
        """``(rows a lane, staged)`` of ``kind``'s sparse step at ``B``
        rows by its tiles: staged where a tile fits a block's shared memory
        (else the tile in global memory, one row a lane), two rows a lane
        from ``RT_TWO_ROWS_MIN`` rows where two fit (``rt_plan`` takes one
        where the list step's segments would not fit beside them)."""
        staged = self.rt_stage(kind)
        if not staged:
            return 1, False
        rows = _FORCE.get(kind + "_rows") or (
            2 if B >= RT_TWO_ROWS_MIN
            and rt_smem(self.dims, kind, 2) <= SMEM_LIMIT else 1)
        if rt_smem(self.dims, kind, rows) > SMEM_LIMIT:
            raise ValueError(
                f"emlp_block: {kind} tile of {self.dims} at {rows} rows a "
                f"lane needs {rt_smem(self.dims, kind, rows)} bytes of "
                f"shared memory, over {SMEM_LIMIT}")
        return rows, True

    def rt_words(self, rows, staged):
        """The sparse steps' packed index as one int32 tensor on this
        spec's device: each nonzero's ``(j, i)`` (``nnz``), then each list
        entry's ``(o, partner)`` (``2 nnz``), ``hi << 16 | lo``; staged,
        offsets into the tile (``c (32 rows + 1)``), else coordinates."""
        key = ("rt_words", rows, staged)
        hit = self._plans.get(key)
        if hit is None:
            pitch = 32 * rows + 1 if staged else 1
            if (self.ng - 1) * pitch >= 1 << 16:
                raise ValueError(
                    f"emlp_block: {self.ng} coordinates at pitch {pitch} "
                    f"do not pack into 16 bits")
            o, j, i = (self.idx[k].cpu().numpy().astype(np.int64)
                       for k in ("o", "j", "i"))
            _, _, lo, partner = self.lists
            words = np.concatenate([(j * pitch) << 16 | i * pitch,
                                    (lo * pitch) << 16 | partner * pitch])
            hit = self._plans[key] = torch.as_tensor(
                words.astype(np.uint32).view(np.int32), device=self.device)
        return hit

    def rt_segments(self):
        """The list step's segments (``rt_segments``) as one int32 tensor
        on this spec's device, ``seg`` then ``cseg``, and their count."""
        hit = self._plans.get("rt_segments")
        if hit is None:
            seg, cseg = rt_segments(self.lists[0])
            hit = self._plans["rt_segments"] = (
                torch.as_tensor(np.concatenate([seg, cseg]).astype(np.int32),
                                device=self.device), len(seg) - 1)
        return hit

    def _rt_build(self, kind, B, sms, rows, staged):
        """``(plan, cols, segs, smem)`` of ``kind`` in one layout."""
        tiles = -(-B // (32 * rows))
        target = sms * rt_blocks_per_sm(
            rt_smem(self.dims, kind, rows if staged else 0))
        if kind == "forward":
            # a column's warps each at least one coordinate
            n_atoms = len(rt_atoms(self.gate, self.nh))
            cols = max(1, min(n_atoms, self.ng // RT_WARPS,
                              round(target / tiles)))
            plan = rt_forward_plan(self.gate, self.rowptr, self.nh, cols)
            segs = 0
        else:
            seg, cseg = rt_segments(self.lists[0])
            groups = min(RT_SLOTS // rows, tiles)
            # a column's warps each at least one segment
            cols = max(1, min(self.ng, (len(seg) - 1) // RT_WARPS,
                              target // groups))
            plan, segs = rt_backward_plan(self.lists[0], seg, cseg,
                                          self.nnz, cols)
        return plan, cols, segs, rt_smem(self.dims, kind,
                                         rows if staged else 0, segs)

    def rt_plan(self, kind, B, sms) -> RtPlan:
        """``kind``'s run-time plan at ``B`` rows on a card of ``sms`` SMs
        (``RtPlan``; the plan ``rt_forward_plan`` or ``rt_backward_plan``
        as an int32 tensor on this spec's device) in ``rt_layout``'s
        layout, the list step at one row a lane where two rows' tiles and
        its segments' shares would not fit.  The block columns fill one wave
        of the blocks the SMs hold at the tiles' shared memory, each warp of
        a column with work: the forward's grid is the tiles of ``32 rows``
        rows by its columns (runs of whole atoms), the list step's the slot
        groups in use by its columns (runs of coordinates, their segments
        dealt to the warps).  A layout that does not fit raises."""
        rows, staged = self.rt_layout(kind, B)
        key = ("rt_plan", kind, B, sms, rows, staged)
        hit = self._plans.get(key)
        if hit is None:
            plan, cols, segs, smem = self._rt_build(kind, B, sms, rows,
                                                    staged)
            if smem > SMEM_LIMIT and rows == 2 \
                    and kind + "_rows" not in _FORCE:
                rows = 1
                plan, cols, segs, smem = self._rt_build(kind, B, sms, rows,
                                                        staged)
            if smem > SMEM_LIMIT:
                raise ValueError(
                    f"emlp_block: the run-time {kind} step of {self.dims} "
                    f"at {B} rows ({rows} a lane, {cols} columns, {segs} "
                    f"segments a column) needs {smem} bytes of shared "
                    f"memory, over {SMEM_LIMIT}")
            hit = self._plans[key] = RtPlan(
                torch.as_tensor(plan.astype(np.int32), device=self.device),
                cols, rows, staged, segs)
        return hit

    def plan_args(self, kind, groups):
        """``kind``'s plan as its kernel takes it: one int32 tensor on this
        spec's device and the host ``meta`` array."""
        key = ("args", kind, groups)
        hit = self._plans.get(key)
        if hit is None:
            p = self.plan(kind, groups)
            flat = np.concatenate([p.hdr.reshape(-1)]
                                  + [a.reshape(-1) for a in p.arrays])
            hit = self._plans[key] = (
                torch.as_tensor(flat.astype(np.int32), device=self.device),
                (ctypes.c_int * len(p.meta))(*p.meta))
        return hit


_SPECS: Dict[tuple, BlockSpec] = {}


def block_spec(blk, device) -> BlockSpec:
    """``BlockSpec`` of an ``EMLPBlock`` module, cached per device."""
    key = (hash(blk.rep_in), hash(blk.rep_out), str(device))
    hit = _SPECS.get(key)
    if hit is None:
        hit = _SPECS[key] = BlockSpec(blk.rep_in, blk.rep_out,
                                      blk.bilinear.rep, device)
    return hit


_GENERAL_SPECS: Dict[tuple, BlockSpec] = {}


def general_block_spec(blk, device) -> BlockSpec:
    """``BlockSpec`` of a ``general_nn.GeneralEMLPBlock``, cached per
    (reps, device): its bilinear map's nonzeros
    (``rep_algebra.bilinear_nonzeros`` of the gated rep, repeats merged),
    its gate indices, and ``runtime_only``.  The appended gate coordinates
    are relabelled in the order their atoms first use them (the run-time
    forward takes a column's gates as one run following its atoms), which
    a caller passes as ``spec.rows``: the row order of ``W_eff`` and
    ``b_eff`` (None where it is already so).  The run-time kernels read
    each nonzero's ``j`` and ``i`` as whole int32s (``RtInts``), so no
    width limit of the instances' 16-bit packing applies."""
    from ..models.emlp.general_nn import gate_indices as general_gates
    from ..models.emlp.rep_algebra import bilinear_nonzeros

    dev = torch.device(device)
    key = (blk.rep_in, blk.rep_out, str(dev))
    hit = _GENERAL_SPECS.get(key)
    if hit is not None:
        return hit
    nin, ng, nh = blk.rep_in.size(), blk.grep.size(), blk.rep_out.size()
    gate = np.asarray(general_gates(blk.rep_out), np.int64)
    J, O, I, P = bilinear_nonzeros(blk.grep, blk.grep)
    tail = gate[gate >= nh]
    _, first = np.unique(tail, return_index=True)
    rows = np.concatenate([np.arange(nh), tail[np.sort(first)]])
    if np.array_equal(rows, np.arange(ng)):
        rows = None
    else:
        new = np.argsort(rows)            # old coordinate -> new
        gate, J, O, I = new[gate], new[J], new[O], new[I]
    idx = merge_nonzeros(J, O, I, P, ng, dev)
    hit = _GENERAL_SPECS[key] = BlockSpec.from_index(
        (nin, ng, nh), idx, gate, dev, runtime_only=True, rows=rows)
    return hit


def merged_values(spec: BlockSpec, bi_params: torch.Tensor) -> torch.Tensor:
    """The merged nonzeros' values ``v``: ``bi_params[P]`` summed into
    their entries (``index_add_``, differentiable in ``bi_params``)."""
    idx = spec.idx
    return bi_params.new_zeros(spec.nnz).index_add_(
        0, idx["inv"], bi_params[idx["P"]])


# ---------------------------------------------------------------------------
# Plain twins (CPU tensors)
# ---------------------------------------------------------------------------
def emlp_block_plain(spec: BlockSpec, x, W, b, v, save: bool = True):
    """``(h (B, nh), lin (ng, B), pre (ng, B))``; ``lin`` and ``pre`` None
    unless ``save``."""
    o, j, i = spec.idx["o"], spec.idx["j"], spec.idx["i"]
    lin = x @ W.T + b
    q = torch.zeros_like(lin).index_add_(1, o, v * lin[:, j] * lin[:, i])
    pre = 0.1 * q + lin
    h = pre[:, :spec.nh] / (1.0 + torch.exp(-pre[:, spec.gidx]))
    if not save:
        return h, None, None
    return h, lin.T.contiguous(), pre.T.contiguous()


def emlp_block_backward_plain(spec: BlockSpec, g_h, x, W, v, lin, pre,
                              need_params: bool):
    """``(g_x, g_W, g_b, g_v)``; the last three are None unless
    ``need_params``."""
    o, j, i, g = spec.idx["o"], spec.idx["j"], spec.idx["i"], spec.gidx
    lin, pre = lin.T, pre.T
    s = 1.0 / (1.0 + torch.exp(-pre[:, g]))
    g_pre = torch.zeros_like(pre)
    g_pre[:, :spec.nh] += g_h * s
    g_pre.index_add_(1, g, g_h * pre[:, :spec.nh] * s * (1.0 - s))
    t = 0.1 * g_pre[:, o] * v
    g_lin = g_pre.clone()
    g_lin.index_add_(1, j, t * lin[:, i])
    g_lin.index_add_(1, i, t * lin[:, j])
    g_x = g_lin @ W
    if not need_params:
        return g_x, None, None, None
    g_v = (0.1 * g_pre[:, o] * lin[:, j] * lin[:, i]).sum(0)
    return g_x, g_lin.T @ x, g_lin.sum(0), g_v


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors)
# ---------------------------------------------------------------------------
def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"emlp_block: {name} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_spec(spec: BlockSpec, x):
    if spec.gidx.device != x.device:
        raise ValueError("emlp_block: block spec is on another device")
    if x.shape[0] <= 0:
        raise ValueError("emlp_block: empty batch")


_SMS: Dict[torch.device, int] = {}


def _sms(dev):
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def emlp_block(spec: BlockSpec, x, W, b, v, save: bool = True):
    """Block forward.  CPU tensors -> ``emlp_block_plain``; CUDA tensors ->
    one kernel launch (float32), or an error.  Returns ``(h, lin, pre)``;
    without ``save`` (no backward follows) ``lin`` and ``pre`` are neither
    allocated nor written, and are None.  ``by_shape`` counts the launches
    per ``(dims, rows, save)``."""
    if not x.is_cuda:
        return emlp_block_plain(spec, x, W, b, v, save)
    if spec.runtime_only or spec.dims not in INSTANCES:
        return emlp_block_any(spec, x, W, b, v, save)
    _check_spec(spec, x)
    B, dev = x.shape[0], x.device
    nin, ng, nh = spec.dims
    for name, t, shape in (("x", x, (B, nin)), ("W_eff", W, (ng, nin)),
                           ("b_eff", b, (ng,)), ("v", v, (spec.nnz,))):
        _check(name, t, shape, dev)
    plan, meta = spec.plan_args("forward",
                                spec.groups("forward", B, _sms(dev)))
    h = torch.empty(B, nh, dtype=torch.float32, device=dev)
    lin = pre = None
    if save:
        lin = torch.empty(ng, B, dtype=torch.float32, device=dev)
        pre = torch.empty(ng, B, dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.emlp_block_fwd_launch(
        x.data_ptr(), B, W.data_ptr(), b.data_ptr(), v.data_ptr(),
        spec.ints.data_ptr(), spec.nnz, plan.data_ptr(), meta, h.data_ptr(),
        lin.data_ptr() if save else None, pre.data_ptr() if save else None,
        nin, ng, nh, torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "emlp_block forward")
    emlp_block.launches += 1
    emlp_block.by_shape[(spec.dims, B, bool(save))] += 1
    return h, lin, pre


emlp_block.launches = 0
emlp_block.by_shape = Counter()


def emlp_block_backward(spec: BlockSpec, g_h, x, W, v, lin, pre,
                        need_params: bool):
    """Block backward.  CPU tensors -> ``emlp_block_backward_plain``; CUDA
    tensors -> one call of the kernels (the main grid, then the sums of
    the groups' shares of ``g_x`` (more than one group) and of the tiles'
    partials (``need_params``)), or an error."""
    if not x.is_cuda:
        return emlp_block_backward_plain(spec, g_h, x, W, v, lin, pre,
                                         need_params)
    if spec.runtime_only or spec.dims not in INSTANCES:
        return emlp_block_backward_any(spec, g_h, x, W, v, lin, pre,
                                       need_params)
    _check_spec(spec, x)
    B, dev = x.shape[0], x.device
    nin, ng, nh = spec.dims
    for name, t, shape in (("x", x, (B, nin)), ("g_h", g_h, (B, nh)),
                           ("W_eff", W, (ng, nin)), ("v", v, (spec.nnz,)),
                           ("lin", lin, (ng, B)), ("pre", pre, (ng, B))):
        _check(name, t, shape, dev)
    G = spec.groups("backward", B, _sms(dev))
    plan, meta = spec.plan_args("backward", G)
    f32 = dict(dtype=torch.float32, device=dev)
    n_par = ng * nin + ng + spec.nnz
    g_x = torch.empty(B, nin, **f32)
    gx_part = torch.empty(G, B, nin, **f32) if G > 1 else g_x
    partial = torch.empty(-(-B // TILE) * n_par if need_params else 1, **f32)
    g_par = torch.empty(n_par if need_params else 1, **f32)
    lib = _lib()
    err = lib.emlp_block_bwd_launch(
        g_h.data_ptr(), x.data_ptr(), B, W.data_ptr(), v.data_ptr(),
        spec.ints.data_ptr(), spec.nnz, lin.data_ptr(), pre.data_ptr(),
        plan.data_ptr(), meta, gx_part.data_ptr(), g_x.data_ptr(),
        partial.data_ptr(), g_par.data_ptr(), int(need_params), nin, ng, nh,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "emlp_block backward")
    emlp_block_backward.launches += 1
    emlp_block_backward.by_shape[(spec.dims, B, bool(need_params))] += 1
    if not need_params:
        return g_x, None, None, None
    g_W = g_par[:ng * nin].view(ng, nin)
    return g_x, g_W, g_par[ng * nin:ng * nin + ng], g_par[ng * nin + ng:]


emlp_block_backward.launches = 0
emlp_block_backward.by_shape = Counter()


def emlp_block_any(spec: BlockSpec, x, W, b, v, save: bool = True):
    """Block forward through the run-time-width kernels, what
    ``emlp_block`` runs for a block without an instance (any ``(nin, ng,
    nh)``; called directly, any block).  CPU tensors ->
    ``emlp_block_plain``; CUDA tensors -> one call (the linear step, then
    the bilinear and gate step: two kernels), or an error; the gate step's
    layout from ``rt_plan``.  Returns ``(h, lin, pre)`` as ``emlp_block``
    (without ``save`` the steps' lin and pre are scratch, not returned);
    ``by_shape`` counts per ``(dims, rows, save)``."""
    if not x.is_cuda:
        return emlp_block_plain(spec, x, W, b, v, save)
    _check_spec(spec, x)
    B, dev = x.shape[0], x.device
    nin, ng, nh = spec.dims
    for name, t, shape in (("x", x, (B, nin)), ("W_eff", W, (ng, nin)),
                           ("b_eff", b, (ng,)), ("v", v, (spec.nnz,))):
        _check(name, t, shape, dev)
    ints = spec.rt_ints()
    plan, cols, rows, staged, _ = spec.rt_plan("forward", B, _sms(dev))
    words = spec.rt_words(rows, staged)
    f32 = dict(dtype=torch.float32, device=dev)
    h, lin = torch.empty(B, nh, **f32), torch.empty(ng, B, **f32)
    pre = torch.empty(ng, B, **f32)
    lib = _lib()
    err = lib.emlp_block_rt_fwd_launch(
        x.data_ptr(), B, W.data_ptr(), b.data_ptr(), v.data_ptr(),
        ints.data_ptr(), spec.nnz, words.data_ptr(), plan.data_ptr(), cols,
        rows, int(staged), h.data_ptr(), lin.data_ptr(), pre.data_ptr(), nin,
        ng, nh, torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "emlp_block_any forward")
    emlp_block_any.launches += 1
    emlp_block_any.by_shape[(spec.dims, B, bool(save))] += 1
    return (h, lin, pre) if save else (h, None, None)


emlp_block_any.launches = 0
emlp_block_any.by_shape = Counter()


def emlp_block_backward_any(spec: BlockSpec, g_h, x, W, v, lin, pre,
                            need_params: bool):
    """Block backward through the run-time-width kernels (g_pre with the
    list entries' values gathered, g_lin, g_x: three kernels; with
    ``need_params`` the parameter sums into
    ``RT_SLOTS`` slots of ``n_par`` floats of scratch and the slots added:
    five), what ``emlp_block_backward`` runs for a block without an
    instance.  CPU tensors -> ``emlp_block_backward_plain``.  The list
    step's layout from ``rt_plan``.  ``by_shape`` counts per ``(dims,
    rows, need_params)``."""
    if not x.is_cuda:
        return emlp_block_backward_plain(spec, g_h, x, W, v, lin, pre,
                                         need_params)
    _check_spec(spec, x)
    B, dev = x.shape[0], x.device
    nin, ng, nh = spec.dims
    for name, t, shape in (("x", x, (B, nin)), ("g_h", g_h, (B, nh)),
                           ("W_eff", W, (ng, nin)), ("v", v, (spec.nnz,)),
                           ("lin", lin, (ng, B)), ("pre", pre, (ng, B))):
        _check(name, t, shape, dev)
    ints = spec.rt_ints()
    plan, cols, rows, staged, most = spec.rt_plan("backward", B, _sms(dev))
    words = spec.rt_words(rows, staged)[spec.nnz:]
    segs, n_seg = spec.rt_segments()
    f32 = dict(dtype=torch.float32, device=dev)
    n_par = ng * nin + ng + spec.nnz
    gpre, glin = torch.empty(ng, B, **f32), torch.empty(ng, B, **f32)
    vl = torch.empty(max(1, 2 * spec.nnz), **f32)
    g_x = torch.empty(B, nin, **f32)
    slots = torch.empty(RT_SLOTS * n_par if need_params else 1, **f32)
    g_par = torch.empty(n_par if need_params else 1, **f32)
    lib = _lib()
    err = lib.emlp_block_rt_bwd_launch(
        g_h.data_ptr(), x.data_ptr(), B, W.data_ptr(), v.data_ptr(),
        ints.data_ptr(), spec.nnz, words.data_ptr(), segs.data_ptr(), n_seg,
        lin.data_ptr(), pre.data_ptr(), plan.data_ptr(), cols, most, rows,
        int(staged), gpre.data_ptr(), glin.data_ptr(), vl.data_ptr(),
        g_x.data_ptr(), slots.data_ptr(),
        g_par.data_ptr(), int(need_params), nin, ng, nh,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "emlp_block_backward_any")
    emlp_block_backward_any.launches += 1
    emlp_block_backward_any.by_shape[(spec.dims, B, bool(need_params))] += 1
    if not need_params:
        return g_x, None, None, None
    g_W = g_par[:ng * nin].view(ng, nin)
    return g_x, g_W, g_par[ng * nin:ng * nin + ng], g_par[ng * nin + ng:]


emlp_block_backward_any.launches = 0
emlp_block_backward_any.by_shape = Counter()


class EMLPBlockFn(torch.autograd.Function):
    """``h = block(x; W_eff, b_eff, v)`` with K3 forward and K4 backward.
    The backward skips the parameter reductions when no parameter needs a
    gradient (the actor loss differentiates through the critic only with
    respect to its action input)."""

    @staticmethod
    def forward(ctx, x, W, b, v, spec):
        h, lin, pre = emlp_block(spec, x, W, b, v)
        ctx.spec = spec
        ctx.save_for_backward(x, W, v, lin, pre)
        return h

    @staticmethod
    def backward(ctx, g_h):
        x, W, v, lin, pre = ctx.saved_tensors
        need_params = any(ctx.needs_input_grad[1:4])
        g_x, g_W, g_b, g_v = emlp_block_backward(
            ctx.spec, g_h.contiguous(), x, W, v, lin, pre, need_params)
        return (g_x if ctx.needs_input_grad[0] else None, g_W, g_b, g_v,
                None)


def block_apply(spec: BlockSpec, x, W, b, v) -> torch.Tensor:
    """The block on ``x`` through K3/K4 under autograd; when autograd
    records nothing, K3 alone, saving neither ``lin`` nor ``pre``."""
    args = [t.contiguous() for t in (x, W, b, v)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return EMLPBlockFn.apply(*args, spec)
    return emlp_block(spec, *args, save=False)[0]


def emlp_trunk(net, params: Dict[str, torch.Tensor], prefix: str,
               x: torch.Tensor):
    """The blocks of ``net`` (an ``EMLP``, ``EMLPActorDet`` or
    ``EMLPActorSAC``: anything with ``named_blocks``) on ``x`` with the
    parameters ``params[<block prefix> + "linear.kernel"]`` etc. (views of a
    flat leaf on the training path): each block's raw kernel and bias are
    projected (K5, differentiable), its bilinear values merged
    (``bilinear_sparse``), then the block runs through K3/K4."""
    for pre, blk in net.named_blocks(prefix):
        W, b = project_linear(blk.linear.rep_in, blk.linear.rep_out,
                              params[pre + "linear.kernel"],
                              params[pre + "linear.bias"])
        spec = block_spec(blk, x.device)
        bi = params.get(pre + "bilinear.bi_params")
        v = (bilinear_sparse(blk.bilinear.rep, bi)[3] if bi is not None
             else W.new_zeros(spec.nnz))
        x = block_apply(spec, x, W, b, v)
    return x


def fold_linear(layer, params: Dict[str, torch.Tensor], prefix: str):
    """An ``EquivLinear``'s ``(W_eff (out, in), b_eff)`` from
    ``params[prefix + "kernel"]``/``"bias"``: the projection (K5)."""
    return project_linear(layer.rep_in, layer.rep_out,
                          params[prefix + "kernel"], params[prefix + "bias"])


def equiv_linear(layer, params: Dict[str, torch.Tensor], prefix: str,
                 x: torch.Tensor):
    """An ``EquivLinear`` with ``params[prefix + "kernel"]``/``"bias"``:
    the projection (K5) and a torch matmul."""
    W, b = fold_linear(layer, params, prefix)
    return x @ W.T + b


def emlp_apply(net, params: Dict[str, torch.Tensor], prefix: str,
               x: torch.Tensor):
    """``net``'s blocks (``emlp_trunk``), then its equivariant head."""
    pre, head = net.named_head(prefix)
    return equiv_linear(head, params, pre, emlp_trunk(net, params, prefix, x))
