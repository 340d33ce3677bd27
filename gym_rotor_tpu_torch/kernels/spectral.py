"""K7: the power iteration of the spectral-norm regularizer, one launch per
regularized network per update.

Replaces the 10-step iteration inside
``gym_rotor_tpu/algos/regularizers.py:102`` ``spectral_norm_regularization``
(batched ``(K, mo, mi)`` matvecs over the zero-padded weight stack, XLA
unrolled on the TPU).  Kernel: ``csrc/spectral.cu``.  Plain twin:
``spectral_iterate_plain``, which is what runs on CPU tensors.

The iterate is detached in JAX (``stop_gradient``), so this computes only
the iterate ``v``; ``sigma = |W v|`` and its gradient stay torch autograd
(``algos/regularizers.py``).  What bounds it on an H100: by the count,
the operations (~1.8 MFLOP for a twin critic's six matrices); in fact the
chain of 20 dependent matvecs a matrix and the launch.  Design: one block
per matrix; W staged in shared memory by the whole block, then two
register-resident pieces of it a thread (a row pass for ``y = W x``, whose
lanes' shares go to shared memory, and a column pass for ``x = Wᵀ y /
|x|`` with a butterfly over a column's lanes), each pass one barrier, every
sum in a fixed order; the instance is chosen by the padded shape
(``INSTANCES``).  ``csrc/spectral.cu`` has the details.  Stacks past the
instances' 128 x 128 (critics from ``critic_hidden_dim`` ~64 up) run the
run-time-width kernel (``spectral_iterate_any``): W read from global
memory (L2) on each matvec, a warp a row (the lanes' sums added in lane
order) and a thread a column.
"""
from __future__ import annotations

import ctypes

import torch

from .build import KernelSource, check
from .emlp_block import SMEM_LIMIT

KERNEL = KernelSource("spectral", [])
WRAPPERS = {"spectral_iterate": "spectral_iterate_plain",
            "spectral_iterate_any": "spectral_iterate_plain"}
ITERS = 10
# The kernel's instances, smallest first: matrices of at most MO x MI, CA
# lanes a row in the row pass, RB lanes a column in the column pass, MO * CA
# threads iterating, NS staging W (csrc/spectral.cu: SPECTRAL_INSTANCES)
INSTANCES = ((32, 32, 2, 2, 256), (128, 64, 1, 2, 256),
             (128, 128, 4, 4, 512))


def instance(mo: int, mi: int):
    """``(MO, MI, CA, RB, NS)`` of the instance a padded ``(mo, mi)``
    stack runs on, or None (no kernel for it)."""
    for geo in INSTANCES:
        if mo <= geo[0] and mi <= geo[1]:
            return geo
    return None


def smem_bytes(mo: int, mi: int) -> int:
    """Dynamic shared memory of a launch: two buffers of x, the row lanes'
    shares of y and the staged matrix at pitch MI + 4 (the kernel's
    ``Geo::smem``)."""
    MO, MI, CA = instance(mo, mi)[:3]
    return 4 * (2 * MI + CA * MO + mo * (MI + 4))


def _lib():
    lib = KERNEL.load()
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.spectral_launch.argtypes = [P, P, P, I, I, I, I, P]
        lib.spectral_launch.restype = I
        lib.spectral_geometry.argtypes = [I, I, P]
        lib.spectral_geometry.restype = ctypes.c_longlong
        lib.spectral_any_launch.argtypes = [P, P, P, I, I, I, I, I, P]
        lib.spectral_any_launch.restype = I
        lib._typed = True
    return lib


def spectral_iterate_plain(Ws: torch.Tensor, x: torch.Tensor,
                           iters: int = ITERS) -> torch.Tensor:
    """``iters`` steps of ``x <- Wᵀ(W x) / |Wᵀ(W x)|`` per matrix, as
    ``regularizers.py:138-141`` writes them."""
    for _ in range(iters):
        y = torch.einsum("kij,kj->ki", Ws, x)
        x = torch.einsum("kij,ki->kj", Ws, y)
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x


# the run-time kernel's partial sums: a row's 32 lanes at this pitch
ANY_PITCH = 33


def any_geometry(mo: int, mi: int):
    """``(chunk, shared memory bytes)`` of a run-time-width launch
    (``spectral_any_launch``): two buffers of x, y, and the row pass's
    lane sums of ``chunk`` rows, as many rows as fit beside them (all
    ``mo`` where they fit)."""
    fixed = 4 * (2 * mi + mo)
    chunk = max(1, min(mo, (SMEM_LIMIT - fixed) // (4 * ANY_PITCH)))
    return chunk, fixed + 4 * ANY_PITCH * chunk


def _checked(Ws, x, what):
    K, mo, mi = Ws.shape
    dev = Ws.device
    for name, t, shape in (("Ws", Ws, (K, mo, mi)), ("x", x, (K, mi))):
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"float32 {shape} tensor on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return K, mo, mi, torch.empty(K, mi, dtype=torch.float32, device=dev)


def spectral_iterate(Ws: torch.Tensor, x: torch.Tensor,
                     iters: int = ITERS) -> torch.Tensor:
    """The detached power-iteration iterate ``v`` (K, mi) of the padded
    stack ``Ws`` (K, mo, mi) from the start vectors ``x`` (K, mi).  CPU
    tensors -> ``spectral_iterate_plain``; CUDA tensors -> one launch
    (float32) of the instance that fits, else of the run-time-width
    kernel (``spectral_iterate_any``), or an error."""
    Ws, x = Ws.detach(), x.detach()
    if not Ws.is_cuda:
        return spectral_iterate_plain(Ws, x, iters)
    if instance(*Ws.shape[1:]) is None:
        return spectral_iterate_any(Ws, x, iters)
    K, mo, mi, v = _checked(Ws, x, "spectral_iterate")
    lib = _lib()
    err = lib.spectral_launch(Ws.data_ptr(), x.data_ptr(), v.data_ptr(), K,
                              mo, mi, iters,
                              torch.cuda.current_stream(Ws.device).cuda_stream)
    check(err, lib, "spectral_iterate")
    spectral_iterate.launches += 1
    return v


spectral_iterate.launches = 0


def spectral_iterate_any(Ws: torch.Tensor, x: torch.Tensor,
                         iters: int = ITERS) -> torch.Tensor:
    """``spectral_iterate`` through the run-time-width kernel (any (mo,
    mi); called directly, any stack).  CPU tensors ->
    ``spectral_iterate_plain``."""
    Ws, x = Ws.detach(), x.detach()
    if not Ws.is_cuda:
        return spectral_iterate_plain(Ws, x, iters)
    K, mo, mi, v = _checked(Ws, x, "spectral_iterate_any")
    lib = _lib()
    err = lib.spectral_any_launch(
        Ws.data_ptr(), x.data_ptr(), v.data_ptr(), K, mo, mi, iters,
        any_geometry(mo, mi)[0],
        torch.cuda.current_stream(Ws.device).cuda_stream)
    check(err, lib, "spectral_iterate_any")
    spectral_iterate_any.launches += 1
    return v


spectral_iterate_any.launches = 0
