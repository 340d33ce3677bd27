"""K6: the fused flat optimizer step, one call per network per update.

Replaces ``gym_rotor_tpu/algos/common.py``'s optax chain
(``clip_by_global_norm`` -> ``adamw`` with ``cosine_warm_restarts``) and
``flat_polyak``, which XLA fused on the TPU.  Kernel:
``csrc/flat_adamw.cu`` (CUDA C++: one reduction and one elementwise pass
need nothing Triton would add, and the port's other kernels share the same
``nvcc``/``ctypes`` build).  Plain twin: ``flat_adamw_plain``, which is
what runs on CPU tensors and repeats optax's order of operations.

The host computes the per-step scalars (``algos/common.py``): the bias
corrections ``1 - b**(count + 1)`` in double, rounded to the parameter
dtype as optax's ``astype`` does under x64, and the step ``-lr(count)``
from the schedule in float32.  Parameters, moments and the target are
updated in place: the kernel writes through raw pointers, so whoever owns
the parameters bumps its explicit version counter after the call
(``models/emlp/zoo.py``, ``param_version``).

What bounds it on an H100: the bytes (~32 B per element, ~2 MB for the
largest network: ~0.6 us at 3.35 TB/s); at these sizes the launch itself
dominates.  So a clipped step is one launch: ``flat_adamw_plan(n)`` spreads
the vector over thread-block clusters, each of which sums the whole
gradient's squares in one fixed order (its blocks' sums meeting in
distributed shared memory) and updates its own share; the unclipped step is
one thread an element.  No scratch memory.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..ops.so3 import sqrt_rn
from .build import KernelSource, check

KERNEL = KernelSource("flat_adamw", ["-fmad=false"])
WRAPPERS = {"flat_adamw": "flat_adamw_plain"}
MAX_CLUSTER = 16       # blocks a cluster (Hopper's largest, non-portable)
MAX_CLUSTERS = 8       # clusters (or solo blocks), each reading all of g
BLOCK_THREADS = 256
SOLO_ELEMS = 2048      # up to here, blocks of their own: no cluster
MAX_N = 1 << 30        # the kernel's int indexing


class FlatAdamWPlan(NamedTuple):
    """The clipped launch's shape: ``clusters`` of ``cluster`` blocks of
    ``threads`` threads; thread ``q`` of cluster ``c`` owns slots
    ``[c per_thread, (c + 1) per_thread)``, slot ``k`` being element
    ``q + k cluster threads``."""
    clusters: int
    cluster: int
    threads: int
    per_thread: int


@functools.lru_cache(maxsize=None)
def flat_adamw_plan(n: int) -> FlatAdamWPlan:
    """One element a thread in blocks of ``BLOCK_THREADS`` (fewer, a
    multiple of 32, for a small vector): up to ``SOLO_ELEMS`` elements in
    blocks of their own, past that in clusters of ``MAX_CLUSTER``; blocks
    double their threads (to 1024) while more than ``MAX_CLUSTERS``
    clusters would be needed, and past that a thread takes more slots.
    Depends on ``n`` alone, so a rerun sums in the same order."""
    if n < 1:
        raise ValueError(f"flat_adamw_plan: n must be positive, got {n}")
    T = min(BLOCK_THREADS, 32 * -(-n // 32))
    C = 1 if n <= SOLO_ELEMS else MAX_CLUSTER
    while T < 1024 and C * T * MAX_CLUSTERS < n:
        T *= 2
    G = min(MAX_CLUSTERS, -(-n // (C * T)))
    return FlatAdamWPlan(G, C, T, -(-n // (G * C * T)))


@dataclass(frozen=True)
class StepScalars:
    """One update's constants: ``max_norm`` (None: no clipping), Adam's
    ``b1``, ``b2``, ``eps``, the decoupled ``wd``, the bias corrections
    ``bc1``, ``bc2`` at ``count + 1``, ``step = -lr(count)``, and ``tau``
    for Polyak (used when a target is given)."""
    max_norm: Optional[float]
    b1: float
    b2: float
    eps: float
    wd: float
    bc1: float
    bc2: float
    step: float
    tau: float


def _lib():
    lib = KERNEL.load()
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flat_adamw_launch.argtypes = [P, P, P, P, P] + [I] * 5 \
            + [F] * 12 + [P]
        lib.flat_adamw_launch.restype = I
        lib.empty_launch.argtypes = [I, I, I, P]
        lib.empty_launch.restype = I
        lib._typed = True
    return lib


def flat_adamw_plain(p, g, mu, nu, s: StepScalars,
                     target: Optional[torch.Tensor] = None):
    """The chain in optax's order, updating ``p``, ``mu``, ``nu`` (and
    ``target``) in place."""
    if s.max_norm is not None:
        norm = sqrt_rn(torch.sum(g * g))
        g = torch.where(norm < s.max_norm, g, (g / norm) * s.max_norm)
    mu.copy_((1 - s.b1) * g + s.b1 * mu)
    nu.copy_((1 - s.b2) * (g * g) + s.b2 * nu)
    u = (mu / s.bc1) / (sqrt_rn(nu / s.bc2) + s.eps)
    u = u + s.wd * p
    p.copy_(p + s.step * u)
    if target is not None:
        target.copy_(s.tau * p + (1.0 - s.tau) * target)


def _check(name, t, n, device):
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(f"flat_adamw: {name} must be a contiguous float32 "
                         f"({n},) tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def flat_adamw(p, g, mu, nu, s: StepScalars,
               target: Optional[torch.Tensor] = None):
    """One optimizer step on a flat parameter vector, in place.  CPU tensors
    -> ``flat_adamw_plain``; CUDA tensors -> one launch of the kernel
    (float32), or an error."""
    if not p.is_cuda:
        return flat_adamw_plain(p, g, mu, nu, s, target)
    n, dev = p.numel(), p.device
    if not 0 < n <= MAX_N:
        raise ValueError(f"flat_adamw: the vector must hold 1 to {MAX_N} "
                         f"elements, got {n}")
    for name, t in (("params", p), ("grad", g), ("mu", mu), ("nu", nu)) + \
            ((("target", target),) if target is not None else ()):
        _check(name, t, n, dev)
    lib = _lib()
    plan = flat_adamw_plan(n)
    err = lib.flat_adamw_launch(
        p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
        None if target is None else target.data_ptr(), n, *plan,
        -1.0 if s.max_norm is None else s.max_norm, s.b1, 1 - s.b1, s.b2,
        1 - s.b2, s.eps, s.wd, s.bc1, s.bc2, s.step, s.tau, 1.0 - s.tau,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "flat_adamw")
    flat_adamw.launches += 1


flat_adamw.launches = 0


def empty_launch(blocks: int, threads: int, cluster: int = 1, device=None):
    """One launch of an empty kernel (in clusters of ``cluster`` blocks when
    above 1) on ``device``'s current stream: the card's floor for a launch.
    Not counted as a K6 launch."""
    lib = _lib()
    dev = torch.device("cuda") if device is None else torch.device(device)
    check(lib.empty_launch(blocks, threads, cluster,
                           torch.cuda.current_stream(dev).cuda_stream),
          lib, "empty_launch")
