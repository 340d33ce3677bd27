"""The MLP PPO actor's acting forward with K11's head, one CUDA launch per
agent per tick.

Replaces ``gym_rotor_tpu/models/mlp.py:146-171`` ``ActorPPO`` under
``algos/ppo.py:107-116`` ``choose_action_f``: the two relu layers, the mean
head, ``tanh``, the clipped draw ``clip(mean + exp(log_std) noise)`` and
the per-dimension log-prob of the clipped action (``mlp.py:173``), or
``(clip(mean), zeros)`` in eval mode; XLA ran it as one program on the
TPU.  Kernel: ``csrc/mlp_ppo_actor.cu`` (its head is K11's,
``csrc/ppo_head.cuh``).  Plain twin: ``mlp_ppo_actor_plain``
(``models/mlp.py::actor_ppo_pre``, then ``emlp_actor.ppo_head_plain``),
which is what runs on CPU tensors.  The PPO loss's forward and backward
through the MLP actor stay ``F.linear`` and K13.

What bounds it on an H100: tiny either way (~0.13 us of bytes at 4096
rows); the launch and one row's chain hold it.  Design
(``csrc/mlp_ppo_actor.cu``): a row on 4 lanes, 32 rows a block; each block
stages the weights, read from the bound parameter tensors each call (views
of the learner's flat vector, so nothing to re-key when the optimizer
writes them), and its rows' obs in shared memory; the hidden units split
over the row's lanes, exchanged through shared memory; every dot product
in one fixed order.  Other widths (a config's ``actor_hidden_dim``) run
the run-time-width kernel (``mlp_ppo_actor_any``), the MLP SAC actor's
design: 8 rows a block, the weights read from global memory.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models.mlp import actor_ppo_pre
from .build import KernelSource, check
from .emlp_actor import _plain_into, ppo_head_plain

KERNEL = KernelSource("mlp_ppo_actor", ["-fmad=false"])
WRAPPERS = {"mlp_ppo_actor": "mlp_ppo_actor_plain",
            "mlp_ppo_actor_any": "mlp_ppo_actor_plain"}
# (obs dim, hidden width, action dim) of the built instances: the MODUL
# actors (agents 0 and 1) and the MONO actor
INSTANCES = {(15, 16, 4), (3, 4, 1), (23, 16, 4)}
# the actor's parameters in the kernel's order
PARAMS = ("Dense_0.kernel", "Dense_0.bias", "Dense_1.kernel", "Dense_1.bias",
          "mean.kernel", "mean.bias", "log_std")


def _lib():
    lib = KERNEL.load()
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mlp_ppo_actor_launch.argtypes = [P, I, I, I, I] + [P] * 8 \
            + [I, P, I, P, I, F, P]
        lib.mlp_ppo_actor_launch.restype = I
        lib.mlp_ppo_actor_any_launch.argtypes = \
            lib.mlp_ppo_actor_launch.argtypes
        lib.mlp_ppo_actor_any_launch.restype = I
        lib._typed = True
    return lib


def actor_dims(actor):
    """(obs dim, hidden width, action dim) of an ``ActorPPO``."""
    nin, nh = actor.Dense_0.kernel.shape
    return int(nin), int(nh), int(actor.mean.kernel.shape[1])


def mlp_ppo_actor_plain(actor, obs, noise: Optional[torch.Tensor] = None):
    """``ActorPPO``'s mean head (``F.linear`` chain) and K11's head:
    ``(clip(tanh(pre) + exp(log_std) noise), per-dim log-prob)``, or
    ``(clip(tanh(pre)), zeros)`` without ``noise``."""
    pre = actor_ppo_pre(actor.params(), obs)
    return ppo_head_plain(pre, actor.log_std, noise, actor.max_action)


def _launch(entry: str, actor, obs, noise, out, logp):
    """One launch of ``entry`` (the instances' or the run-time widths'
    launcher) on checked operands; returns ``(out, logp)``."""
    nin, nh, nact = actor_dims(actor)
    B, dev = obs.shape[0], obs.device
    if obs.dtype != torch.float32 or obs.shape != (B, nin) \
            or not obs.is_contiguous() or B == 0:
        raise ValueError(f"mlp_ppo_actor: obs must be a contiguous float32 "
                         f"(B, {nin}) tensor with B > 0, got {obs.dtype} "
                         f"{tuple(obs.shape)}")
    params = actor.params()
    weights = [params[k] for k in PARAMS]
    for name, t in zip(PARAMS, weights):
        if t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"mlp_ppo_actor: {name} must be contiguous "
                             f"float32 on {dev}")
    if out is None:
        out = torch.empty(B, nact, dtype=torch.float32, device=dev)
    if logp is None:
        logp = torch.empty(B, nact, dtype=torch.float32, device=dev)
    for name, t in (("out", out), ("logp", logp), ("noise", noise)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.shape != (B, nact) \
                or t.stride(1) != 1 or t.device != dev:
            raise ValueError(f"mlp_ppo_actor: {name} must be a float32 ({B}, "
                             f"{nact}) tensor with unit column stride on "
                             f"{dev}")
    lib = _lib()
    err = getattr(lib, entry)(
        obs.data_ptr(), B, nin, nh, nact, *(t.data_ptr() for t in weights),
        None if noise is None else noise.data_ptr(),
        0 if noise is None else noise.stride(0), out.data_ptr(),
        out.stride(0), logp.data_ptr(), logp.stride(0),
        float(actor.max_action), torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, entry)
    return out, logp


def mlp_ppo_actor(actor, obs: torch.Tensor,
                  noise: Optional[torch.Tensor] = None,
                  out: Optional[torch.Tensor] = None,
                  logp: Optional[torch.Tensor] = None):
    """The acting draw of an MLP ``ActorPPO``: ``(action, per-dim
    log-prob)``, both ``(B, act)``, with the N(0, 1) draw ``noise``, or
    ``(clip(tanh(mean)), zeros)`` when ``noise`` is None (eval).  CPU
    tensors -> ``mlp_ppo_actor_plain``; CUDA tensors -> one kernel launch
    (float32): the instance of the actor's widths, else the run-time
    widths' kernel (``mlp_ppo_actor_any``), or an error.  ``out`` and
    ``logp`` (unit column stride, any row stride) receive the results in
    place: a column slice of the joint action and of the horizon's
    log-prob rows."""
    if not obs.is_cuda:
        a, lp = mlp_ppo_actor_plain(actor, obs, noise)
        return _plain_into(a, out), _plain_into(lp, logp)
    if actor_dims(actor) not in INSTANCES:
        return mlp_ppo_actor_any(actor, obs, noise, out, logp)
    res = _launch("mlp_ppo_actor_launch", actor, obs, noise, out, logp)
    mlp_ppo_actor.launches += 1
    return res


mlp_ppo_actor.launches = 0


def mlp_ppo_actor_any(actor, obs: torch.Tensor,
                      noise: Optional[torch.Tensor] = None,
                      out: Optional[torch.Tensor] = None,
                      logp: Optional[torch.Tensor] = None):
    """``mlp_ppo_actor`` through the run-time-width kernel (any widths;
    called directly, any actor).  CPU tensors -> ``mlp_ppo_actor_plain``."""
    if not obs.is_cuda:
        a, lp = mlp_ppo_actor_plain(actor, obs, noise)
        return _plain_into(a, out), _plain_into(lp, logp)
    res = _launch("mlp_ppo_actor_any_launch", actor, obs, noise, out, logp)
    mlp_ppo_actor_any.launches += 1
    return res


mlp_ppo_actor_any.launches = 0
