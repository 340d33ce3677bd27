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

K11's head alone (``ppo_head``) serves PPO's MLP actor (``models/mlp.py``
``ActorPPO``), whose mean is an ``F.linear`` chain: one launch over the
mean head's pre-tanh output draws the action and writes it and its
per-dimension log-prob in place, through the same device function as
K11's epilogue.  Plain twin: ``ppo_head_plain``.  SAC's MLP actor needs no
kernel of its own here: its sample is K10's forward
(``kernels/sac_sample.py``) on the ``F.linear`` outputs.

What bounds it on an H100: the operations, and few of them.  Per row and
block the linear layer is ``2 ng nin`` flops and the bilinear layer three
per nonzero of its quadratic form (``bilinear_sparse``: 288 for agent 0's
18 gated channels, where a dense ``ng^3`` form would hold 5832), so agent 0
at B = 4096 is ~13 MFLOP against ~0.3 MB of obs/actions: ~0.2 us at the
fp32 peak.  Design: the folded weights (``W_eff``, ``b_eff`` from
``project_linear``, K5), the bilinear nonzeros grouped by output
coordinate, and the gate indices sit in shared memory (a few KB); one
thread per batch row keeps its activations in registers, with a copy of
each block's linear output in a per-thread shared-memory column that the
nonzeros index.  No cuBLAS call: every product of the actor is in the
kernel body.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ..models.emlp.nn import (bilinear_index, bilinear_sparse,
                               gate_indices, gated)
from ..models.mlp import gaussian_logprob, sac_sample_with_noise
from .build import KernelSource, check

KERNEL = KernelSource("emlp_actor", [])
WRAPPERS = {"emlp_actor": "emlp_actor_plain", "sac_actor": "sac_actor_plain",
            "ppo_actor": "ppo_actor_plain", "ppo_head": "ppo_head_plain"}
HEAD_TANH, HEAD_GAUSS, HEAD_PPO = 0, 1, 2
# Per head, the (obs dim, gated width, hidden width, action dim) of the
# built instances: the flagship MODUL actors (agents 0 and 1) and the MONO
# actor, for every head.
_BUILT = {(15, 18, 16, 4), (3, 7, 4, 1), (23, 18, 16, 4)}
INSTANCES = {HEAD_TANH: _BUILT, HEAD_GAUSS: _BUILT, HEAD_PPO: _BUILT}


def _lib():
    lib = KERNEL.load()
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.emlp_actor_launch.argtypes = [P, I, P, I, P, I, I, I, P, I, P,
                                          I, P, I, F, I, I, I, I, I, P]
        lib.emlp_actor_launch.restype = I
        lib.ppo_head_launch.argtypes = [P, I, I, P, P, I, P, I, P, I, F, P]
        lib.ppo_head_launch.restype = I
        lib._typed = True
    return lib


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
    index)``.  The kernel's buffers: ``params`` (float) packs, per block,
    ``W_eff (ng, nin)``, ``b_eff (ng,)``, ``v (nnz,)``, then the head
    ``W (nact, nh)`` and ``b (nact,)`` and, for the SAC actor, the log_std
    Dense's kernel transposed to ``(nact, nh)`` and its bias, for the PPO
    actor the ``log_std`` parameter ``(nact,)``; ``ints``
    packs both blocks' gate indices, then both blocks' row pointers (``ng +
    1`` each: the nonzeros of output ``o`` are ``rowptr[o]:rowptr[o +
    1]``), then both blocks' ``j << 16 | i``."""
    cached = getattr(actor, "_folded", None)
    if cached is not None and cached[0] == actor.param_version:
        return cached[1]
    dims = actor_dims(actor)
    blocks, idx = [], []
    with torch.no_grad():
        for _, blk in actor.named_blocks():
            W, b = blk.linear.effective()
            sp = bilinear_sparse(blk.bilinear.rep, blk.bilinear.bi_params)
            g = torch.as_tensor(gate_indices(blk.rep_out), device=W.device)
            blocks.append((W, b, sp, g))
            idx.append(bilinear_index(blk.bilinear.rep, W.device))
        Wh, bh = actor.named_head()[1].effective()
        tail = [Wh.reshape(-1), bh]
        log_std = getattr(actor, "log_std_linear", None)
        if log_std is not None:
            tail += [log_std.kernel.T.reshape(-1), log_std.bias]
        elif isinstance(getattr(actor, "log_std", None), torch.nn.Parameter):
            tail.append(actor.log_std.reshape(-1))
    flat = torch.cat([t.reshape(-1) for W, b, (*_, v), _ in blocks
                      for t in (W, b, v)] + tail)
    ints = torch.cat([g.to(torch.int32) for *_, g in blocks]
                     + [d["rowptr"] for d in idx] + [d["ji"] for d in idx])
    folded = dict(dims=dims, blocks=blocks, head=(Wh, bh),
                  nnz=tuple(int(v.numel()) for _, _, (*_, v), _ in blocks),
                  params=flat.contiguous(), ints=ints.contiguous())
    actor._folded = (actor.param_version, folded)
    fold_actor.folds += 1
    return folded


fold_actor.folds = 0


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


def _launch(actor, obs, out, noise, head: int, what: str, logp=None):
    """One launch of the actor kernel with ``head``; returns ``(out,
    logp)`` (``logp`` is written by the PPO head only, else None)."""
    folded = fold_actor(actor)
    nin, ng, nh, nact = dims = folded["dims"]
    if dims not in INSTANCES[head]:
        raise NotImplementedError(f"{what} has no kernel instance for "
                                  f"(nin, ng, nh, nact) = {dims}")
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
    params, ints = folded["params"], folded["ints"]
    if params.device != obs.device or params.dtype != torch.float32:
        raise ValueError(f"{what}: actor weights must be float32 on the "
                         "same device as obs")
    lib = _lib()
    err = lib.emlp_actor_launch(
        obs.data_ptr(), B, params.data_ptr(), params.numel(), ints.data_ptr(),
        ints.numel(), *folded["nnz"],
        None if noise is None else noise.data_ptr(),
        0 if noise is None else noise.stride(0), out.data_ptr(),
        out.stride(0), None if logp is None else logp.data_ptr(),
        0 if logp is None else logp.stride(0),
        getattr(actor, "max_action", 1.0), nin, ng, nh, nact, head,
        torch.cuda.current_stream(obs.device).cuda_stream)
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
    out = _launch(actor, obs, out, None, HEAD_TANH, "emlp_actor")[0]
    emlp_actor.launches += 1
    return out


emlp_actor.launches = 0


def sac_actor(actor, obs: torch.Tensor, noise: Optional[torch.Tensor] = None,
              out: Optional[torch.Tensor] = None):
    """SAC actor's action (K9): ``tanh(mean + exp(log_std) noise)`` with the
    N(0, 1) draw ``noise`` (``(B, act_dim)``, unit column stride), or
    ``tanh(mean)`` when ``noise`` is None (eval).  CPU tensors ->
    ``sac_actor_plain``; CUDA tensors -> one kernel launch (float32), or an
    error.  ``out`` as for ``emlp_actor``."""
    if not obs.is_cuda:
        return _plain_into(sac_actor_plain(actor, obs, noise), out)
    out = _launch(actor, obs, out, noise, HEAD_GAUSS, "sac_actor")[0]
    sac_actor.launches += 1
    return out


sac_actor.launches = 0


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
    res = _launch(actor, obs, out, noise, HEAD_PPO, "ppo_actor", logp)
    ppo_actor.launches += 1
    return res


ppo_actor.launches = 0


def ppo_head_plain(pre, log_std, noise: Optional[torch.Tensor] = None,
                   max_action: float = 1.0):
    """K11's head on a pre-tanh mean ``pre`` (B, act) with the free
    ``log_std`` (1, act): ``mean = tanh(pre)``, then ``(clip(mean +
    exp(log_std) noise), gaussian_logprob of it)`` or, without ``noise``,
    ``(clip(mean), zeros)`` (ppo.py:107-116)."""
    mean = torch.tanh(pre)
    return _ppo_draw(mean, log_std.expand_as(mean), noise, max_action)


def ppo_head(pre: torch.Tensor, log_std: torch.Tensor,
             noise: Optional[torch.Tensor] = None,
             out: Optional[torch.Tensor] = None,
             logp: Optional[torch.Tensor] = None, max_action: float = 1.0):
    """PPO's acting draw on an MLP actor's pre-tanh mean ``pre`` (B, act):
    ``(action, per-dim log-prob)``, or ``(clip(tanh(pre)), zeros)`` when
    ``noise`` is None (eval).  CPU tensors -> ``ppo_head_plain``; CUDA
    tensors -> one kernel launch (float32), or an error.  ``out`` and
    ``logp`` (unit column stride, any row stride) receive the results in
    place, as ``ppo_actor``'s do."""
    if not pre.is_cuda:
        a, lp = ppo_head_plain(pre, log_std, noise, max_action)
        return _plain_into(a, out), _plain_into(lp, logp)
    B = pre.shape[0]
    if pre.dim() != 2 or B == 0 or pre.dtype != torch.float32 \
            or not pre.is_contiguous():
        raise ValueError(f"ppo_head: pre must be a contiguous float32 (B, "
                         f"act) tensor with B > 0, got {pre.dtype} "
                         f"{tuple(pre.shape)}")
    nact, dev = int(pre.shape[1]), pre.device
    if log_std.dtype != torch.float32 or log_std.numel() != nact \
            or not log_std.is_contiguous() or log_std.device != dev:
        raise ValueError(f"ppo_head: log_std must be {nact} contiguous "
                         f"float32 values on {dev}")
    if out is None:
        out = torch.empty(B, nact, dtype=torch.float32, device=dev)
    if logp is None:
        logp = torch.empty(B, nact, dtype=torch.float32, device=dev)
    for name, t in (("out", out), ("logp", logp), ("noise", noise)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.shape != (B, nact) \
                or t.stride(1) != 1 or t.device != dev:
            raise ValueError(f"ppo_head: {name} must be a float32 ({B}, "
                             f"{nact}) tensor with unit column stride on "
                             f"{dev}")
    lib = _lib()
    err = lib.ppo_head_launch(
        pre.data_ptr(), B, nact, log_std.data_ptr(),
        None if noise is None else noise.data_ptr(),
        0 if noise is None else noise.stride(0), out.data_ptr(),
        out.stride(0), logp.data_ptr(), logp.stride(0), float(max_action),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "ppo_head")
    ppo_head.launches += 1
    return out, logp


ppo_head.launches = 0
