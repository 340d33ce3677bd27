"""K13: PPO's clipped surrogate with its entropy bonus, forward and backward,
under ``torch.autograd``.

Replaces ``gym_rotor_tpu/algos/ppo.py:247-258`` (the surrogate part of the
actor loss) and its autodiff in ``jax.value_and_grad``, which XLA fused
into the actor update on the TPU.  Kernel: ``csrc/ppo_loss.cu``.  Plain
twins: ``ppo_loss_plain`` (the expression of ``ppo.py:250-258``) and
``ppo_loss_backward_plain`` (its derivative written out as the kernel
computes it), which are what run on CPU tensors.

The backward is JAX's derivative at ties: ``jnp.minimum`` and the two
halves of ``jnp.clip`` (``maximum(lo, x)``, then ``minimum(hi, .)``) give
each side half the cotangent where the two are equal.  Inside the clip
range ``s1 == s2`` exactly and the halves add up to the whole; at
``ratio == 1 +- clip_rate`` the clip passes half.  ``log_std`` is shared by
every row (``zoo.py:213`` broadcasts it), so its gradient is a sum over
rows, in a fixed order on the card.  The entropy coefficient and the
cotangent stay on the device (0-d tensors the kernel reads).

What bounds it on an H100: the bytes (~0.19 MB at a 3723-row minibatch of
4 actions, ~0.06 us); the launch itself dominates.  So each direction is
one launch: ``ppo_loss_plan(B)`` gives one block up to ``BLOCK_ROWS`` rows
and past that one thread-block cluster, whose blocks' sums meet in
distributed shared memory, a thread a row (more rows a thread past one
pass).  No scratch memory.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..models.mlp import gaussian_entropy, gaussian_logprob
from .build import KernelSource, check

KERNEL = KernelSource("ppo_loss", ["-fmad=false"])
WRAPPERS = {"ppo_loss": "ppo_loss_plain",
            "ppo_loss_backward": "ppo_loss_backward_plain"}
MAX_ACT = 4
MAX_CLUSTER = 16       # blocks a cluster (Hopper's largest, non-portable)
MAX_THREADS = 1024
BLOCK_ROWS = 256       # rows a block aims at
MAX_ROWS = 1 << 26


class PPOLossPlan(NamedTuple):
    """``cluster`` blocks (one cluster when above 1) of ``threads``; thread
    ``q`` takes rows ``q, q + S, ...`` (``S = cluster threads``),
    ``rows_per_thread`` of them."""
    cluster: int
    threads: int
    rows_per_thread: int


@functools.lru_cache(maxsize=None)
def ppo_loss_plan(B: int) -> PPOLossPlan:
    """One block up to ``BLOCK_ROWS`` rows (a multiple of 32 threads);
    beyond, a power-of-two cluster of up to ``MAX_CLUSTER`` blocks of about
    ``BLOCK_ROWS`` rows each, threads growing to 1024 and then rows a
    thread.  Depends on ``B`` alone, so a rerun sums in the same order."""
    if B < 1:
        raise ValueError(f"ppo_loss_plan: B must be positive, got {B}")
    C = 1
    while C < MAX_CLUSTER and C * BLOCK_ROWS < B:
        C *= 2
    T = min(MAX_THREADS, 32 * -(-B // (32 * C)))
    return PPOLossPlan(C, T, -(-B // (C * T)))


def _lib():
    lib = KERNEL.load()
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ppo_loss_fwd_launch.argtypes = [P] * 6 + [I] * 5 + [F, F, P, P]
        lib.ppo_loss_fwd_launch.restype = I
        lib.ppo_loss_bwd_launch.argtypes = [P] * 7 + [I] * 5 + [F, F, P, P,
                                                                P]
        lib.ppo_loss_bwd_launch.restype = I
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# Plain twins (CPU tensors)
# ---------------------------------------------------------------------------
def _ratio(mean, log_std, act, lp_old):
    ls = log_std.reshape(1, -1).expand_as(mean)
    lp = gaussian_logprob(mean, ls, act)
    return torch.exp(lp.sum(-1, keepdim=True)
                     - lp_old.sum(-1, keepdim=True)), ls


def ppo_loss_plain(mean, log_std, act, lp_old, adv, coef, clip_rate: float):
    """``-(min(ratio adv, clip(ratio, 1 -+ clip_rate) adv) + coef
    entropy).mean()`` over the ``(mb, act)`` rows (``ppo.py:250-258``);
    ``log_std`` is ``(act,)`` or ``(1, act)``, ``adv`` ``(mb, 1)``,
    ``coef`` a 0-d tensor."""
    ratio, ls = _ratio(mean, log_std, act, lp_old)
    entropy = torch.sum(gaussian_entropy(ls), dim=-1, keepdim=True)
    s1 = ratio * adv
    s2 = torch.clamp(ratio, 1.0 - clip_rate, 1.0 + clip_rate) * adv
    return -(torch.minimum(s1, s2) + coef * entropy).mean()


def _tie(a_wins, tie):
    """1 where ``a_wins``, 1/2 where ``tie``, else 0 (JAX's min/max rule)."""
    return torch.where(a_wins, 1.0, torch.where(tie, 0.5, 0.0))


def ppo_loss_backward_plain(g, mean, log_std, act, lp_old, adv, coef,
                            clip_rate: float):
    """``(g_mean (mb, act), g_log_std (log_std's shape))`` of
    ``ppo_loss_plain`` for the loss cotangent ``g`` (0-d)."""
    lo, hi = 1.0 - clip_rate, 1.0 + clip_rate
    ratio, ls = _ratio(mean, log_std, act, lp_old)
    std = torch.exp(ls)
    z = (act - mean) / std
    s1 = ratio * adv
    m1 = torch.clamp(ratio, min=lo)
    s2 = torch.clamp(m1, max=hi) * adv
    gt = -g / mean.shape[0]
    w1 = _tie(s1 < s2, s1 == s2).to(mean.dtype)
    w2 = _tie(s2 < s1, s1 == s2).to(mean.dtype)
    c_hi = _tie(m1 < hi, m1 == hi).to(mean.dtype)
    c_lo = _tie(ratio > lo, ratio == lo).to(mean.dtype)
    g_m1 = gt * w2 * adv * c_hi
    g_s = (gt * w1 * adv + g_m1 * c_lo) * ratio
    g_mean = g_s * z / std
    g_ls = (g_s * (z * z - 1.0) + gt * coef).sum(0)
    return g_mean, g_ls.reshape(log_std.shape)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors)
# ---------------------------------------------------------------------------
def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"ppo_loss: {name} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _checked(mean, log_std, act, lp_old, adv, coef):
    if mean.dim() != 2 or not 1 <= mean.shape[1] <= MAX_ACT \
            or not 0 < mean.shape[0] <= MAX_ROWS:
        raise ValueError(f"ppo_loss: mean must be (B, act) with 0 < B <= "
                         f"{MAX_ROWS} and act <= {MAX_ACT}, got "
                         f"{tuple(mean.shape)}")
    B, A = int(mean.shape[0]), int(mean.shape[1])
    dev = mean.device
    for name, t, shape in (("mean", mean, (B, A)), ("act", act, (B, A)),
                           ("lp_old", lp_old, (B, A)), ("adv", adv, (B, 1)),
                           ("coef", coef, ())):
        _check(name, t, shape, dev)
    if log_std.numel() != A:
        raise ValueError(f"ppo_loss: log_std must hold {A} values")
    ls = log_std.reshape(A)
    _check("log_std", ls, (A,), dev)
    return B, A, dev, ls


def ppo_loss(mean, log_std, act, lp_old, adv, coef, clip_rate: float):
    """Forward.  CPU tensors -> ``ppo_loss_plain``; CUDA tensors -> one
    launch of the kernel (float32, act <= 4), or an error.  Returns the 0-d
    loss."""
    if not mean.is_cuda:
        return ppo_loss_plain(mean, log_std, act, lp_old, adv, coef,
                              clip_rate)
    B, A, dev, ls = _checked(mean, log_std, act, lp_old, adv, coef)
    lib = _lib()
    loss = torch.empty((), dtype=torch.float32, device=dev)
    err = lib.ppo_loss_fwd_launch(
        mean.data_ptr(), ls.data_ptr(), act.data_ptr(), lp_old.data_ptr(),
        adv.data_ptr(), coef.data_ptr(), B, A, *ppo_loss_plan(B),
        1.0 - clip_rate, 1.0 + clip_rate, loss.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "ppo_loss forward")
    ppo_loss.launches += 1
    return loss


ppo_loss.launches = 0


def ppo_loss_backward(g, mean, log_std, act, lp_old, adv, coef,
                      clip_rate: float):
    """Backward.  CPU tensors -> ``ppo_loss_backward_plain``; CUDA tensors
    -> one launch of the kernel, or an error.  Returns ``(g_mean,
    g_log_std)`` (``g_log_std`` in ``log_std``'s shape)."""
    if not mean.is_cuda:
        return ppo_loss_backward_plain(g, mean, log_std, act, lp_old, adv,
                                       coef, clip_rate)
    B, A, dev, ls = _checked(mean, log_std, act, lp_old, adv, coef)
    _check("g", g, (), dev)
    lib = _lib()
    g_mean = torch.empty(B, A, dtype=torch.float32, device=dev)
    g_ls = torch.empty(A, dtype=torch.float32, device=dev)
    err = lib.ppo_loss_bwd_launch(
        mean.data_ptr(), ls.data_ptr(), act.data_ptr(), lp_old.data_ptr(),
        adv.data_ptr(), coef.data_ptr(), g.data_ptr(), B, A,
        *ppo_loss_plan(B), 1.0 - clip_rate, 1.0 + clip_rate,
        g_mean.data_ptr(), g_ls.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "ppo_loss backward")
    ppo_loss_backward.launches += 1
    return g_mean, g_ls.reshape(log_std.shape)


ppo_loss_backward.launches = 0


class PPOSurrogateFn(torch.autograd.Function):
    """``loss = surrogate(mean, log_std; act, lp_old, adv, coef)`` with
    K13's forward and backward; everything but ``mean`` and ``log_std`` is
    a constant."""

    @staticmethod
    def forward(ctx, mean, log_std, act, lp_old, adv, coef, clip_rate):
        ctx.save_for_backward(mean, log_std, act, lp_old, adv, coef)
        ctx.clip_rate = clip_rate
        return ppo_loss(mean, log_std, act, lp_old, adv, coef, clip_rate)

    @staticmethod
    def backward(ctx, g):
        mean, log_std, act, lp_old, adv, coef = ctx.saved_tensors
        g_mean, g_ls = ppo_loss_backward(g.contiguous(), mean, log_std, act,
                                         lp_old, adv, coef, ctx.clip_rate)
        return g_mean, g_ls, None, None, None, None, None


def ppo_surrogate(mean, log_std, act, lp_old, adv, coef, clip_rate: float):
    """The clipped surrogate with its entropy bonus through K13 under
    autograd (differentiable in ``mean`` and ``log_std``)."""
    return PPOSurrogateFn.apply(mean.contiguous(), log_std.contiguous(),
                                act.contiguous(), lp_old.contiguous(),
                                adv.contiguous(), coef, clip_rate)
