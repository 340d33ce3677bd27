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
``o``.  The forward saves ``lin`` and ``pre`` (field-major, ``(ng, B)``).
The backward of a nonzero ``(o, j, i, v)`` is
``g_lin[j] += 0.1 v g_pre[o] lin[i]``, ``g_lin[i] += 0.1 v g_pre[o] lin[j]``
and ``g_v[e] = sum over rows of 0.1 g_pre[o] lin[j] lin[i]``; the gate's
two terms land on one coordinate where ``gate_idx[c] == c`` (SiLU).  The
sums over rows of ``g_W``, ``g_b`` and ``g_v`` are per-block partials and
a second pass, in a fixed order, so a run repeats its numbers.  Gradients
reach the raw ``kernel``/``bias`` through ``project_linear`` (K5, torch
autograd) and ``bi_params`` through ``bilinear_sparse``'s ``index_add_``.

What bounds it on an H100: the operations, and few.  Agent 1's critic
block 1 (123 gated channels, 9394 nonzeros) at B = 256 is ~11 MFLOP
forward, ~0.17 us at the fp32 peak; the serial chain of each row
dominates.  Design: one thread per row (as ``emlp_actor.cu``), W_eff, b_eff
and the nonzeros in shared memory (up to 186 KB for agent 1's critic, so
the dynamic-memory limit is raised per device and instance).
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict

import torch

from ..models.emlp.nn import (bilinear_index, bilinear_sparse, gate_indices,
                               project_linear)
from .build import KernelSource, check

KERNEL = KernelSource("emlp_block", [])
WRAPPERS = {"emlp_block": "emlp_block_plain",
            "emlp_block_backward": "emlp_block_backward_plain"}
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


def _lib():
    lib = KERNEL.load()
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.emlp_block_fwd_launch.argtypes = [P, I, P, P, I, P, P, P, I, I,
                                              I, P]
        lib.emlp_block_fwd_launch.restype = I
        lib.emlp_block_bwd_launch.argtypes = [P, P, I, P, P, I, P, P, P, P,
                                              P, I, I, I, I, P]
        lib.emlp_block_bwd_launch.restype = I
        lib.emlp_block_rows_per_block.argtypes = []
        lib.emlp_block_rows_per_block.restype = I
        lib._typed = True
    return lib


class BlockSpec:
    """The static side of one block: sizes, the bilinear index (int32 for
    the kernel, int64 for the plain twin) and the gate indices, per
    device."""

    def __init__(self, rep_in, rep_out, grep, device):
        self.nin, self.ng, self.nh = rep_in.size, grep.size, rep_out.size
        self.idx = bilinear_index(grep, device)
        self.nnz = int(self.idx["o"].numel())
        g = torch.as_tensor(gate_indices(rep_out), device=device)
        self.gidx = g.to(torch.int64)
        self.ints = torch.cat([g.to(torch.int32), self.idx["rowptr"],
                               self.idx["ji"], self.idx["o32"]]).contiguous()

    @property
    def dims(self):
        return (self.nin, self.ng, self.nh)


_SPECS: Dict[tuple, BlockSpec] = {}


def block_spec(blk, device) -> BlockSpec:
    """``BlockSpec`` of an ``EMLPBlock`` module, cached per device."""
    key = (hash(blk.rep_in), hash(blk.rep_out), str(device))
    hit = _SPECS.get(key)
    if hit is None:
        hit = _SPECS[key] = BlockSpec(blk.rep_in, blk.rep_out,
                                      blk.bilinear.rep, device)
    return hit


# ---------------------------------------------------------------------------
# Plain twins (CPU tensors)
# ---------------------------------------------------------------------------
def emlp_block_plain(spec: BlockSpec, x, W, b, v):
    """``(h (B, nh), lin (ng, B), pre (ng, B))``."""
    o, j, i = spec.idx["o"], spec.idx["j"], spec.idx["i"]
    lin = x @ W.T + b
    q = torch.zeros_like(lin).index_add_(1, o, v * lin[:, j] * lin[:, i])
    pre = 0.1 * q + lin
    h = pre[:, :spec.nh] / (1.0 + torch.exp(-pre[:, spec.gidx]))
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


def _params(spec: BlockSpec, W, b, v):
    return torch.cat([W.reshape(-1), b, v]).contiguous()


def emlp_block(spec: BlockSpec, x, W, b, v):
    """Block forward.  CPU tensors -> ``emlp_block_plain``; CUDA tensors ->
    one kernel launch (float32), or an error.  Returns ``(h, lin, pre)``."""
    if not x.is_cuda:
        return emlp_block_plain(spec, x, W, b, v)
    if spec.dims not in INSTANCES:
        raise NotImplementedError(f"emlp_block has no kernel instance for "
                                  f"(nin, ng, nh) = {spec.dims}")
    B, dev = x.shape[0], x.device
    nin, ng, nh = spec.dims
    if B <= 0:
        raise ValueError("emlp_block: empty batch")
    _check("x", x, (B, nin), dev)
    params = _params(spec, W, b, v)
    _check("W_eff/b_eff/v", params, (ng * nin + ng + spec.nnz,), dev)
    if spec.ints.device != dev:
        raise ValueError("emlp_block: block spec is on another device")
    h = torch.empty(B, nh, dtype=torch.float32, device=dev)
    lin = torch.empty(ng, B, dtype=torch.float32, device=dev)
    pre = torch.empty(ng, B, dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.emlp_block_fwd_launch(
        x.data_ptr(), B, params.data_ptr(), spec.ints.data_ptr(), spec.nnz,
        h.data_ptr(), lin.data_ptr(), pre.data_ptr(), nin, ng, nh,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "emlp_block forward")
    emlp_block.launches += 1
    emlp_block.by_shape[(spec.dims, B)] += 1
    return h, lin, pre


emlp_block.launches = 0
emlp_block.by_shape = Counter()


def emlp_block_backward(spec: BlockSpec, g_h, x, W, v, lin, pre,
                        need_params: bool):
    """Block backward.  CPU tensors -> ``emlp_block_backward_plain``; CUDA
    tensors -> one call of the kernel (one grid launch for ``g_x``, plus
    the partial and final reductions when ``need_params``), or an error."""
    if not x.is_cuda:
        return emlp_block_backward_plain(spec, g_h, x, W, v, lin, pre,
                                         need_params)
    if spec.dims not in INSTANCES:
        raise NotImplementedError(f"emlp_block has no kernel instance for "
                                  f"(nin, ng, nh) = {spec.dims}")
    B, dev = x.shape[0], x.device
    nin, ng, nh = spec.dims
    _check("x", x, (B, nin), dev)
    _check("g_h", g_h, (B, nh), dev)
    _check("lin", lin, (ng, B), dev)
    _check("pre", pre, (ng, B), dev)
    params = _params(spec, W, v.new_zeros(ng), v)
    f32 = dict(dtype=torch.float32, device=dev)
    g_x = torch.empty(B, nin, **f32)
    n_par = ng * nin + ng + spec.nnz
    lib = _lib()
    rows = lib.emlp_block_rows_per_block()
    n_blk = (B + rows - 1) // rows
    partial = torch.empty(n_blk * n_par if need_params else 1, **f32)
    g_par = torch.empty(n_par if need_params else 1, **f32)
    err = lib.emlp_block_bwd_launch(
        g_h.data_ptr(), x.data_ptr(), B, params.data_ptr(),
        spec.ints.data_ptr(), spec.nnz, lin.data_ptr(), pre.data_ptr(),
        g_x.data_ptr(),
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
    """The block on ``x`` through K3/K4 under autograd."""
    return EMLPBlockFn.apply(x.contiguous(), W.contiguous(), b.contiguous(),
                             v.contiguous(), spec)


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


def equiv_linear(layer, params: Dict[str, torch.Tensor], prefix: str,
                 x: torch.Tensor):
    """An ``EquivLinear`` with ``params[prefix + "kernel"]``/``"bias"``:
    the projection (K5) and a torch matmul."""
    W, b = project_linear(layer.rep_in, layer.rep_out,
                          params[prefix + "kernel"], params[prefix + "bias"])
    return x @ W.T + b


def emlp_apply(net, params: Dict[str, torch.Tensor], prefix: str,
               x: torch.Tensor):
    """``net``'s blocks (``emlp_trunk``), then its equivariant head."""
    pre, head = net.named_head(prefix)
    return equiv_linear(head, params, pre, emlp_trunk(net, params, prefix, x))
