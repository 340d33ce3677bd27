"""K7: the power iteration of the spectral-norm regularizer, one launch per
regularized network per update.

Replaces the 10-step iteration inside
``gym_rotor_tpu/algos/regularizers.py:102`` ``spectral_norm_regularization``
(batched ``(K, mo, mi)`` matvecs over the zero-padded weight stack, XLA
unrolled on the TPU).  Kernel: ``csrc/spectral.cu``.  Plain twin:
``spectral_iterate_plain``, which is what runs on CPU tensors.

The iterate is detached in JAX (``stop_gradient``), so this computes only
the iterate ``v``; ``sigma = |W v|`` and its gradient stay torch autograd
(``algos/regularizers.py``).  What bounds it on an H100: the operations
(~1.8 MFLOP for a twin critic's six matrices), far under the launch and the
30 dependent steps; one block per matrix keeps its W in shared memory.
"""
from __future__ import annotations

import ctypes

import torch

from .build import KernelSource, check

KERNEL = KernelSource("spectral", [])
WRAPPERS = {"spectral_iterate": "spectral_iterate_plain"}
ITERS = 10


def _lib():
    lib = KERNEL.load()
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.spectral_launch.argtypes = [P, P, P, I, I, I, I, P]
        lib.spectral_launch.restype = I
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


def spectral_iterate(Ws: torch.Tensor, x: torch.Tensor,
                     iters: int = ITERS) -> torch.Tensor:
    """The detached power-iteration iterate ``v`` (K, mi) of the padded
    stack ``Ws`` (K, mo, mi) from the start vectors ``x`` (K, mi).  CPU
    tensors -> ``spectral_iterate_plain``; CUDA tensors -> one launch
    (float32), or an error."""
    Ws, x = Ws.detach(), x.detach()
    if not Ws.is_cuda:
        return spectral_iterate_plain(Ws, x, iters)
    K, mo, mi = Ws.shape
    dev = Ws.device
    for name, t, shape in (("Ws", Ws, (K, mo, mi)), ("x", x, (K, mi))):
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"spectral_iterate: {name} must be a contiguous "
                             f"float32 {shape} tensor on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    v = torch.empty(K, mi, dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.spectral_launch(Ws.data_ptr(), x.data_ptr(), v.data_ptr(), K,
                              mo, mi, iters,
                              torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "spectral_iterate")
    spectral_iterate.launches += 1
    return v


spectral_iterate.launches = 0
