"""K10: the squashed-Gaussian sample and its summed log-prob, forward and
backward, under ``torch.autograd``.

Replaces ``gym_rotor_tpu/models/mlp.py:129`` ``sac_sample_with_noise`` and
its autodiff in the SAC actor loss, which XLA fused on the TPU.  Kernel:
``csrc/sac_sample.cu``.  Plain twins: ``sac_sample_plain`` (the expression
of ``models/mlp.py``) and ``sac_sample_backward_plain`` (its derivative
written out as the kernel computes it), which are what run on CPU tensors.

The backward differentiates JAX's expression as written: ``z = (x - m) /
std`` reaches ``m`` and ``std`` both directly and through ``x = m + std n``.
The two paths cancel in exact arithmetic (``g_m`` and ``g_std`` carry
``+-g_logp z / std``), and near saturation the cotangent on the action is
``~2 g_logp / ((1 - a^2) + EPS)``, up to ~2e6 ``g_logp``: where ``std`` is
tiny (``log_std`` at its lower clip) or ``a`` is +-1, any two derivations
(JAX's autodiff, this one, the kernel) round those large intermediate
terms differently.  Tests and ``chip_smoke.py`` allow a few ulp of them
per element (``rounding_scales``).

What bounds it on an H100: the bytes (~66 KB at the actor loss's 1024 rows
of 4 actions, ~0.02 us); the launch dominates.  One thread per row.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.mlp import EPS, sac_sample_with_noise
from .build import KernelSource, check

KERNEL = KernelSource("sac_sample", ["-fmad=false"])
WRAPPERS = {"sac_sample": "sac_sample_plain",
            "sac_sample_backward": "sac_sample_backward_plain"}
MAX_ACT = 4


def _lib():
    lib = KERNEL.load()
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.sac_sample_fwd_launch.argtypes = [P, P, P, I, I, P, P, P]
        lib.sac_sample_fwd_launch.restype = I
        lib.sac_sample_bwd_launch.argtypes = [P, P, P, P, P, I, I, P, P, P]
        lib.sac_sample_bwd_launch.restype = I
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# Plain twins (CPU tensors)
# ---------------------------------------------------------------------------
def sac_sample_plain(mean, log_std, noise):
    """``(action, log_prob (..., 1))``."""
    action, logp, _ = sac_sample_with_noise(mean, log_std, noise)
    return action, logp


def sac_sample_backward_plain(g_action, g_logp, mean, log_std, noise):
    """``(g_mean, g_log_std)`` of ``sac_sample_plain`` for the cotangents
    ``g_action`` (..., act) and ``g_logp`` (..., 1)."""
    std = torch.exp(log_std)
    x = mean + std * noise
    a = torch.tanh(x)
    d = x - mean
    z = d / std
    one_m = 1.0 - a * a
    g_z = -g_logp * z
    g_d = g_z / std
    g_std_z = (-g_z * d) / (std * std)
    g_x = g_action * one_m
    g_x = g_x + g_logp * ((2.0 * a * one_m) / (one_m + EPS))
    g_x = g_x + g_d
    g_std = g_x * noise + g_std_z
    return g_x - g_d, std * g_std - g_logp


def rounding_scales(g_action, g_logp, mean, log_std, noise):
    """Per element, the size of the intermediate terms that ``g_mean`` and
    ``g_log_std`` are sums of: ``|g_logp z / std|`` (the two cancelling
    paths), ``|g_action|`` and the cotangent on the action ``2 |g_logp| /
    ((1 - a^2) + EPS)``; for ``g_log_std`` scaled through ``std n``, plus
    ``|g_logp| (z^2 + 1)``.  Two evaluation orders of the derivative may
    differ by a few ulp of these."""
    std = torch.exp(log_std)
    x = mean + std * noise
    a = torch.tanh(x)
    z = (x - mean) / std
    s = ((g_logp * z / std).abs() + g_action.abs()
         + 2.0 * g_logp.abs() / ((1.0 - a * a) + EPS))
    return s, std * noise.abs() * s + g_logp.abs() * (z * z + 1.0)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors)
# ---------------------------------------------------------------------------
def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"sac_sample: {name} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _dims(mean):
    if mean.dim() != 2 or not 1 <= mean.shape[1] <= MAX_ACT \
            or mean.shape[0] == 0:
        raise ValueError(f"sac_sample: mean must be (B, act) with B > 0 and "
                         f"act <= {MAX_ACT}, got {tuple(mean.shape)}")
    return int(mean.shape[0]), int(mean.shape[1])


def sac_sample(mean, log_std, noise):
    """Forward.  CPU tensors -> ``sac_sample_plain``; CUDA tensors -> one
    kernel launch (float32, (B, act) with act <= 4), or an error."""
    if not mean.is_cuda:
        return sac_sample_plain(mean, log_std, noise)
    B, act = _dims(mean)
    dev = mean.device
    for name, t in (("mean", mean), ("log_std", log_std), ("noise", noise)):
        _check(name, t, (B, act), dev)
    action = torch.empty(B, act, dtype=torch.float32, device=dev)
    logp = torch.empty(B, 1, dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.sac_sample_fwd_launch(
        mean.data_ptr(), log_std.data_ptr(), noise.data_ptr(), B, act,
        action.data_ptr(), logp.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "sac_sample forward")
    sac_sample.launches += 1
    return action, logp


sac_sample.launches = 0


def sac_sample_backward(g_action, g_logp, mean, log_std, noise):
    """Backward.  CPU tensors -> ``sac_sample_backward_plain``; CUDA tensors
    -> one kernel launch, or an error.  Returns ``(g_mean, g_log_std)``."""
    if not mean.is_cuda:
        return sac_sample_backward_plain(g_action, g_logp, mean, log_std,
                                         noise)
    B, act = _dims(mean)
    dev = mean.device
    for name, t in (("g_action", g_action), ("mean", mean),
                    ("log_std", log_std), ("noise", noise)):
        _check(name, t, (B, act), dev)
    _check("g_logp", g_logp, (B, 1), dev)
    g_mean = torch.empty(B, act, dtype=torch.float32, device=dev)
    g_log_std = torch.empty(B, act, dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.sac_sample_bwd_launch(
        g_action.data_ptr(), g_logp.data_ptr(), mean.data_ptr(),
        log_std.data_ptr(), noise.data_ptr(), B, act, g_mean.data_ptr(),
        g_log_std.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "sac_sample backward")
    sac_sample_backward.launches += 1
    return g_mean, g_log_std


sac_sample_backward.launches = 0


class SquashedGaussianFn(torch.autograd.Function):
    """``(action, log_prob) = sample(mean, log_std; noise)`` with K10's
    forward and backward; ``noise`` is a constant draw."""

    @staticmethod
    def forward(ctx, mean, log_std, noise):
        ctx.save_for_backward(mean, log_std, noise)
        return sac_sample(mean, log_std, noise)

    @staticmethod
    def backward(ctx, g_action, g_logp):
        mean, log_std, noise = ctx.saved_tensors
        g_mean, g_log_std = sac_sample_backward(
            g_action.contiguous(), g_logp.contiguous(), mean, log_std, noise)
        return g_mean, g_log_std, None


def squashed_gaussian(mean, log_std, noise):
    """The sample and its summed log-prob ``(action (B, act), log_prob (B,
    1))`` through K10 under autograd."""
    return SquashedGaussianFn.apply(mean.contiguous(), log_std.contiguous(),
                                    noise.contiguous())
