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
run-time-width kernel (``spectral_iterate_any``): a thread-block cluster
per matrix, each block a band of its rows staged in shared memory once,
each iteration a row pass and a column pass over the band, the blocks'
partials of ``Wᵀ y`` added in rank order through distributed shared
memory (``any_plan`` picks the cluster size and the band).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional

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
        lib.spectral_any_launch.argtypes = [P, P, P, I, I, I, I, I, I, I,
                                            I, P]
        lib.spectral_any_launch.restype = I
        lib.spectral_any_active.argtypes = [I, I, I, I, I]
        lib.spectral_any_active.restype = I
        lib.spectral_any_smem.argtypes = [I, I, I]
        lib.spectral_any_smem.restype = ctypes.c_longlong
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


# The run-time kernel's cluster sizes, largest first (16 is Hopper's
# largest, past the portable 8), and its threads a block by width
CLUSTER_SIZES = (16, 8)
ANY_THREADS_NARROW, ANY_THREADS_WIDE = 256, 512


class AnyPlan(NamedTuple):
    """A run-time launch: ``cluster`` blocks a matrix, block ``rank`` the
    rows ``[rank band, (rank + 1) band)``, ``threads`` a block, the band in
    shared memory (``staged``) or read from global memory, ``smem`` bytes
    of dynamic shared memory a block."""
    cluster: int
    band: int
    staged: bool
    threads: int
    smem: int


def any_smem(mi: int, band: int, staged: bool) -> int:
    """Shared memory of a run-time block (``csrc/spectral.cu``
    ``any_smem``): x, two partial slots, y of the band (rounded to 4) and,
    staged, the band at a pitch of ``mi`` rounded to 4."""
    p = (mi + 3) & ~3
    return 4 * (3 * p + ((band + 3) & ~3) + (band * p if staged else 0))


# A layout forced on the run-time kernel for a check at widths that would
# not pick it (``chip_smoke.py``'s phase 26): "staged" -> bool, "cluster"
# -> a size of CLUSTER_SIZES.  Empty in use.
_FORCE: Dict[str, object] = {}


def any_plan(K: int, mo: int, mi: int,
             active: Optional[Callable[[AnyPlan], int]] = None) -> AnyPlan:
    """The run-time launch of a ``(K, mo, mi)`` stack.  Per cluster size
    (16, then 8) the band ``ceil(mo / size)``, staged where it fits
    ``SMEM_LIMIT`` beside the vectors, else read from global memory;
    ``active(plan)`` is how many such clusters the card runs at once (None:
    as many as asked).  First choice: a staged plan whose K clusters run
    at once, the larger cluster first; then a staged one; then any whose
    clusters run at once; then the largest.  Raises where even the vectors
    do not fit a block (``mi`` past ~19 000)."""
    threads = ANY_THREADS_NARROW if mi <= 256 else ANY_THREADS_WIDE
    sizes = [_FORCE["cluster"]] if "cluster" in _FORCE else CLUSTER_SIZES
    plans = []
    for C in sizes:
        band = -(-mo // C)
        for staged in (True, False):
            if "staged" in _FORCE and staged != _FORCE["staged"]:
                continue
            smem = any_smem(mi, band, staged)
            if smem <= SMEM_LIMIT:
                plans.append(AnyPlan(C, band, staged, threads, smem))
                break
    if not plans:
        raise ValueError(f"spectral_iterate_any: a ({mo}, {mi}) matrix's "
                         "vectors exceed a block's shared memory")
    together = [p for p in plans if active is None or active(p) >= K]
    for pool in ([p for p in together if p.staged],
                 [p for p in plans if p.staged], together, plans):
        if pool:
            return pool[0]


_ACTIVE: Dict[tuple, int] = {}


def _active(dev: torch.device, mi: int):
    """``any_plan``'s ``active`` on ``dev`` for ``mi`` columns: the
    library's ``cudaOccupancyMaxActiveClusters`` for a plan's shape,
    cached; a query the card refuses raises."""
    def active(p: AnyPlan) -> int:
        key = (str(dev), p.cluster, p.smem, p.threads, p.staged)
        if key not in _ACTIVE:
            lib = _lib()
            n = lib.spectral_any_active(mi, p.cluster, p.band, p.threads,
                                        int(p.staged))
            if n < 0:
                check(-n, lib, "spectral_iterate_any: occupancy")
            _ACTIVE[key] = n
        return _ACTIVE[key]
    return active


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
    mi); called directly, any stack): one launch of ``any_plan``'s
    clusters.  CPU tensors -> ``spectral_iterate_plain``."""
    Ws, x = Ws.detach(), x.detach()
    if not Ws.is_cuda:
        return spectral_iterate_plain(Ws, x, iters)
    K, mo, mi, v = _checked(Ws, x, "spectral_iterate_any")
    lib = _lib()
    with torch.cuda.device(Ws.device):
        p = any_plan(K, mo, mi, _active(Ws.device, mi))
        err = lib.spectral_any_launch(
            Ws.data_ptr(), x.data_ptr(), v.data_ptr(), K, mo, mi, iters,
            p.cluster, p.band, p.threads, int(p.staged),
            torch.cuda.current_stream(Ws.device).cuda_stream)
    check(err, lib, "spectral_iterate_any")
    spectral_iterate_any.launches += 1
    return v


spectral_iterate_any.launches = 0
