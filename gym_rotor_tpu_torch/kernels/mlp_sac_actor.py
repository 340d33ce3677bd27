"""The MLP SAC actor's acting forward with SAC's head, one CUDA launch per
agent per tick.

Replaces ``gym_rotor_tpu/models/mlp.py:107-119`` ``ActorSAC`` with
``:129-143`` ``sac_sample_with_noise`` under ``algos/sac.py:108-117``
``choose_action_f``: the two relu layers, the mean and clipped log-std
heads and the squashed draw ``tanh(mean + exp(log_std) noise)``, or
``tanh(mean)`` in eval mode; XLA ran it as one program on the TPU.  Kernel:
``csrc/mlp_sac_actor.cu`` (its head is the training path's fused head's,
``csrc/sac_head.cuh``).  Plain twin: ``mlp_sac_actor_plain``
(``models/mlp.py::actor_sac``, then ``sac_sample_plain``), which is what
runs on CPU tensors.  The actor loss's forward and backward through the
MLP actor are ``F.linear`` trunks and the fused head
(``kernels/sac_sample.py``).

What bounds it on an H100: tiny either way (~0.11 us of bytes at 4096
rows); the launch and one row's chain hold it.  Design
(``csrc/mlp_sac_actor.cu``, the MLP PPO actor's): a row on 4 lanes, 32 rows
a block; each block stages the weights, read from the bound parameter
tensors each call (views of the learner's flat vector, so nothing to re-key
when the optimizer writes them), and its rows' obs in shared memory; the
hidden units split over the row's lanes, exchanged through shared memory;
every dot product in one fixed order.  Widths without an instance run one
kernel with run-time widths in the same order, its weights read from
global memory.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import KernelSource, check
from .emlp_actor import _plain_into
from .sac_sample import sac_sample_plain

KERNEL = KernelSource("mlp_sac_actor", ["-fmad=false"])
WRAPPERS = {"mlp_sac_actor": "mlp_sac_actor_plain"}
# the run-time-width kernel's limits (the instances, (obs dim, hidden
# width, action dim) = (15, 16, 4), (3, 4, 1), (23, 16, 4), are within
# them): 8 rows' two hidden layers in a block's shared memory
MAX_HIDDEN = 3632
MAX_ACT = 4
# the actor's parameters in the kernel's order
PARAMS = ("Dense_0.kernel", "Dense_0.bias", "Dense_1.kernel", "Dense_1.bias",
          "mean.kernel", "mean.bias", "log_std.kernel", "log_std.bias")


def _lib():
    lib = KERNEL.load()
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.mlp_sac_actor_launch.argtypes = [P, I, I, I, I] + [P] * 9 \
            + [I, P, I, P]
        lib.mlp_sac_actor_launch.restype = I
        lib._typed = True
    return lib


def actor_dims(actor):
    """(obs dim, hidden width, action dim) of an ``ActorSAC``."""
    nin, nh = actor.Dense_0.kernel.shape
    return int(nin), int(nh), int(actor.mean.kernel.shape[1])


def mlp_sac_actor_plain(actor, obs, noise: Optional[torch.Tensor] = None):
    """``ActorSAC``'s ``dist`` (the ``F.linear`` chain, ``log_std``
    clamped) and the plain sample's action, or ``tanh(mean)`` without
    ``noise``."""
    mean, log_std = actor.dist(obs)
    if noise is None:
        return torch.tanh(mean)
    return sac_sample_plain(mean, log_std, noise.contiguous())[0]


def mlp_sac_actor(actor, obs: torch.Tensor,
                  noise: Optional[torch.Tensor] = None,
                  out: Optional[torch.Tensor] = None):
    """The acting sample of an MLP ``ActorSAC``, ``(B, act)``, with the
    N(0, 1) draw ``noise``, or ``tanh(mean)`` when ``noise`` is None
    (eval).  CPU tensors -> ``mlp_sac_actor_plain``; CUDA tensors -> one
    kernel launch (float32; an instance, or the run-time-width kernel),
    or an error.  ``out`` (unit column stride, any row stride) receives the
    action in place: a column slice of the joint action."""
    if not obs.is_cuda:
        return _plain_into(mlp_sac_actor_plain(actor, obs, noise), out)
    dims = actor_dims(actor)
    nin, nh, nact = dims
    if nh > MAX_HIDDEN or nact > MAX_ACT:
        raise ValueError(f"mlp_sac_actor: (nin, nh, nact) = {dims}; the "
                         f"kernel takes up to {MAX_HIDDEN} hidden units and "
                         f"{MAX_ACT} actions")
    B, dev = obs.shape[0], obs.device
    if obs.dtype != torch.float32 or obs.shape != (B, nin) \
            or not obs.is_contiguous() or B == 0:
        raise ValueError(f"mlp_sac_actor: obs must be a contiguous float32 "
                         f"(B, {nin}) tensor with B > 0, got {obs.dtype} "
                         f"{tuple(obs.shape)}")
    params = actor.params()
    weights = [params[k] for k in PARAMS]
    for name, t in zip(PARAMS, weights):
        if t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"mlp_sac_actor: {name} must be contiguous "
                             f"float32 on {dev}")
    if out is None:
        out = torch.empty(B, nact, dtype=torch.float32, device=dev)
    for name, t in (("out", out), ("noise", noise)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.shape != (B, nact) \
                or t.stride(1) != 1 or t.device != dev:
            raise ValueError(f"mlp_sac_actor: {name} must be a float32 ({B}, "
                             f"{nact}) tensor with unit column stride on "
                             f"{dev}")
    lib = _lib()
    err = lib.mlp_sac_actor_launch(
        obs.data_ptr(), B, nin, nh, nact, *(t.data_ptr() for t in weights),
        None if noise is None else noise.data_ptr(),
        0 if noise is None else noise.stride(0), out.data_ptr(),
        out.stride(0), torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "mlp_sac_actor")
    mlp_sac_actor.launches += 1
    return out


mlp_sac_actor.launches = 0
