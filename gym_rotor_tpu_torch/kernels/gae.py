"""K12: Generalized Advantage Estimation over one horizon, with the TD
targets and the advantages normalised over the whole horizon.

Replaces ``gym_rotor_tpu/algos/ppo.py:119-146`` ``gae`` (a reverse
``lax.scan`` over the time axis, then the mean, the two-pass variance and
the Bessel-corrected std over all ``T*B`` entries), which XLA fused into
the update program on the TPU.  Kernel: ``csrc/gae.cu``.  Plain twin:
``gae_plain``, which is what runs on CPU tensors.  There is no backward:
JAX ``stop_gradient``s both outputs (``ppo.py:205-206``).

What bounds it on an H100: the bytes, 24 an entry (four inputs read, two
outputs written): ~4.9 MB at the 4096-env horizon (T = 50, B = 4096), ~1.5
us.  One thread per env column runs the recursion; the sums over the
horizon are fixed-order block partials recomputed by each block of the
next launch (``csrc/gae.cu``), so a run repeats its numbers.
"""
from __future__ import annotations

import ctypes

import torch

from .build import KernelSource, check

KERNEL = KernelSource("gae", ["-fmad=false"])
WRAPPERS = {"gae": "gae_plain"}


def _lib():
    lib = KERNEL.load()
    if not getattr(lib, "_typed", False):
        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
        lib.gae_scratch_floats.argtypes = [I, L]
        lib.gae_scratch_floats.restype = I
        lib.gae_launch.argtypes = [P, P, P, P, I, I, F, F, P, P, P, P]
        lib.gae_launch.restype = I
        lib._typed = True
    return lib


def normalize_plain(advs):
    """``(advs - m) / (std + 1e-4)`` with ``m`` the mean over every entry,
    the two-pass variance and ``std = sqrt(var n / max(n - 1, 1))``
    (``ppo.py:136-145``, torch's ``.std()`` with Bessel's correction)."""
    m = advs.mean()
    n = advs.numel()
    var = torch.mean((advs - m) ** 2)
    std = torch.sqrt(var * n / max(n - 1, 1))
    return (advs - m) / (std + 1e-4)


def gae_plain(values, next_values, rewards, dones, gamma: float, lam: float):
    """``(normalised advantages, td targets)``, each of the inputs' shape
    ``(T, ...)``: the recursion runs over the leading (time) axis, each of
    the trailing entries (env column) on its own."""
    deltas = rewards + gamma * next_values * (1.0 - dones) - values
    advs = torch.empty_like(deltas)
    carry = torch.zeros_like(deltas[0])
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * (1.0 - dones[t]) * lam * carry
        advs[t] = carry
    return normalize_plain(advs), advs + values


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"gae: {name} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def gae(values, next_values, rewards, dones, gamma: float, lam: float):
    """GAE over a ``(T, B, 1)`` (or ``(T, B)``) horizon.  CPU tensors ->
    ``gae_plain``; CUDA tensors -> one call of the kernel (float32,
    contiguous; three grid launches), or an error.  Returns
    ``(normalised advantages, td targets)`` of the inputs' shape."""
    if not values.is_cuda:
        return gae_plain(values, next_values, rewards, dones, gamma, lam)
    shape, dev = tuple(values.shape), values.device
    if len(shape) not in (2, 3) or (len(shape) == 3 and shape[2] != 1) \
            or shape[0] <= 0 or shape[1] <= 0:
        raise ValueError(f"gae: expected (T, B, 1) or (T, B), got {shape}")
    T, B = shape[0], shape[1]
    for name, t in (("values", values), ("next_values", next_values),
                    ("rewards", rewards), ("dones", dones)):
        _check(name, t, shape, dev)
    adv = torch.empty(shape, dtype=torch.float32, device=dev)
    td = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = _lib()
    scratch = torch.empty(lib.gae_scratch_floats(B, T * B),
                          dtype=torch.float32, device=dev)
    err = lib.gae_launch(
        values.data_ptr(), next_values.data_ptr(), rewards.data_ptr(),
        dones.data_ptr(), T, B, gamma, lam, adv.data_ptr(), td.data_ptr(),
        scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "gae")
    gae.launches += 1
    return adv, td


gae.launches = 0
