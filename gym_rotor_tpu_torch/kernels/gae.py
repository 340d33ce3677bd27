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
us; at PPO A's (218, 32) the serial recursion and the launch.  One launch a
call (``csrc/gae.cu``): CTAs of ``cols`` env columns copy their tile of the
inputs into shared memory (``cp.async``), run the recursion from there a
thread a column, and meet for the mean and the variance in one CTA, one
thread-block cluster or a co-resident grid (``gae_plan``), each sum in a
fixed order, so a run repeats its numbers.  The grid's exchange words and
their epoch live in a per-device scratch (``_scratch``) that every launch
leaves ready for the next, so launches on one device run one after another
(one stream), as the PPO update launches them.

The sharded route (``gae_sharded``, a horizon split over the ranks of a
process group, ``parallel/mesh.py``): no collective can run inside a
launch, so K12 is cut where the mean and the variance must cross the
ranks, three launches around two all-reduces: A the scan, td, the raw
advantages and the rank's mean; the mean averaged over the ranks; B the
rank's variance around it; the variance averaged; C the normalisation
with the std Bessel-corrected over every rank's entries.  A and B sum in
K12's order, so at world 1 the route is bitwise the one launch.  Plain
twin: ``gae_sharded_plain``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..ops.so3 import sqrt_rn
from .build import KernelSource, check

KERNEL = KernelSource("gae", ["-fmad=false"])
WRAPPERS = {"gae": "gae_plain", "gae_sharded": "gae_sharded_plain"}
SHARDED_STAGES = ("mean", "var", "norm")   # gae_sharded's launches a call
MODES = {"solo": 0, "cluster": 1, "grid": 2}
# the plans a sweep chose (scripts/gae_head_vs_parent.py --sweep, PERF.md
# section 6): narrow horizons in one cluster, wider ones in a grid
NARROW_COLS = 256        # up to here one cluster (or one CTA)
NARROW_CLUSTER_COLS = 2  # columns a CTA of that cluster at least
SOLO_ENTRIES = 1024      # below this a narrow horizon takes one CTA (its
                         # 256 threads four entries each at most)
GRID_COLS = 64           # columns a CTA of the grid
MAX_CLUSTER = 16         # Hopper's largest cluster (non-portable)
SMS = 132                # the H100's SMs: the grid's CTAs, one an SM
MAX_THREADS = 1024
MAX_STAGES = 2           # chunk buffers of a streamed tile
SMEM_BYTES = 232448 - 2048   # the kernel's dynamic shared memory at most
MAX_GRID = 256           # CTAs the scratch has room for


class GaePlan(NamedTuple):
    """One launch: ``ctas`` CTAs of ``threads`` threads, ``cols`` env
    columns a CTA (thread c scans column ``cta cols + c``), the horizon in
    ``chunks`` chunks of ``rows`` rows through ``stages`` buffers
    (``resident`` when each chunk has its own: the whole tile stays in
    shared memory), the CTAs' sums meeting by ``mode``."""
    mode: str
    ctas: int
    cols: int
    threads: int
    rows: int
    stages: int
    chunks: int

    @property
    def resident(self) -> bool:
        return self.chunks <= self.stages

    def smem(self, T: int) -> int:
        """Bytes of dynamic shared memory: the four inputs' tile."""
        return 16 * self.cols * (T if self.resident
                                 else self.rows * self.stages)


def _round32(n: int) -> int:
    return 32 * -(-n // 32)


@functools.lru_cache(maxsize=None)
def gae_plan(T: int, B: int, mode: str = None, cols: int = None,
             threads: int = None) -> GaePlan:
    """The launch for a ``(T, B)`` horizon.  Up to ``NARROW_COLS`` columns
    one cluster of CTAs of ``NARROW_CLUSTER_COLS`` columns or more (at most
    ``MAX_CLUSTER`` CTAs; one CTA where one is enough or the horizon holds
    fewer than ``SOLO_ENTRIES`` entries); wider, a grid of
    CTAs of ``GRID_COLS`` columns (more where the columns would need more
    CTAs than ``SMS``).  ``mode``, ``cols`` and ``threads`` override the
    choice (the sweep's other plans).  The tile stays in shared memory when
    it fits, copied as one chunk; else it streams through two chunk
    buffers.  Raises where no plan fits."""
    if T < 1 or B < 1:
        raise ValueError(f"gae_plan: T and B must be positive, got {T}, {B}")
    if mode is None and B > NARROW_COLS:
        mode = "grid"
    elif mode is None:
        narrow = max(NARROW_CLUSTER_COLS, -(-B // MAX_CLUSTER))
        mode = ("cluster" if B > narrow and T * B >= SOLO_ENTRIES
                else "solo")
        cols = cols or (narrow if mode == "cluster" else B)
    if mode == "solo":
        cols = cols or B
    elif mode == "cluster":
        cols = cols or _round32(-(-B // MAX_CLUSTER))
    elif mode == "grid":
        cols = cols or max(GRID_COLS, _round32(-(-B // SMS)))
    else:
        raise ValueError(f"gae_plan: unknown mode {mode!r}")
    ctas = -(-B // cols)
    threads = threads or min(MAX_THREADS, max(256, _round32(cols)))
    if cols > threads or threads > MAX_THREADS or threads % 32:
        raise ValueError(f"gae_plan: {cols} columns a CTA of {threads} "
                         "threads (one thread a column, at most "
                         f"{MAX_THREADS})")
    if (mode == "solo" and ctas != 1) or \
            (mode == "cluster" and ctas > MAX_CLUSTER) or \
            (mode == "grid" and ctas > min(SMS, MAX_GRID)):
        raise ValueError(f"gae_plan: {B} columns need {ctas} CTAs, more "
                         f"than the {mode} mode takes")
    if 16 * T * cols <= SMEM_BYTES:
        return GaePlan(mode, ctas, cols, threads, T, 1, 1)
    rows = SMEM_BYTES // (2 * 16 * cols)
    return GaePlan(mode, ctas, cols, threads, rows, 2, -(-T // rows))


def _lib(kernel: KernelSource = KERNEL):
    """``kernel``'s library (this build or another build of ``gae.cu``)
    with its C functions typed."""
    lib = kernel.load()
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gae_launch.argtypes = [P, P, P, P, I, I, F, F, P, P] \
            + [I] * 6 + [P, P]
        lib.gae_launch.restype = I
        lib.gae_stage_launch.argtypes = [P, P, P, P, I, I, F, F, P, P] \
            + [I] * 6 + [P, I, P, P, P]
        lib.gae_stage_launch.restype = I
        lib.gae_norm_launch.argtypes = [P, ctypes.c_longlong, P, P,
                                        ctypes.c_longlong, P]
        lib.gae_norm_launch.restype = I
        lib._typed = True
    return lib


_SCRATCH = {}


def _scratch(device) -> torch.Tensor:
    """The device's grid scratch, 64-bit words zeroed once: the epoch (each
    launch tags its exchange words from it, then moves it on), then two
    words a CTA (a tag and a sum)."""
    key = str(device)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.zeros(1 + 2 * MAX_GRID, dtype=torch.int64,
                                    device=device)
    return _SCRATCH[key]


def normalize_plain(advs):
    """``(advs - m) / (std + 1e-4)`` with ``m`` the mean over every entry,
    the two-pass variance and ``std = sqrt(var n / max(n - 1, 1))``
    (``ppo.py:136-145``, torch's ``.std()`` with Bessel's correction)."""
    m = advs.mean()
    n = advs.numel()
    var = torch.mean((advs - m) ** 2)
    std = sqrt_rn(var * n / max(n - 1, 1))
    return (advs - m) / (std + 1e-4)


def _scan_plain(values, next_values, rewards, dones, gamma, lam):
    """The raw advantages: the recursion over the leading (time) axis, each
    of the trailing entries (env column) on its own."""
    deltas = rewards + gamma * next_values * (1.0 - dones) - values
    advs = torch.empty_like(deltas)
    carry = torch.zeros_like(deltas[0])
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * (1.0 - dones[t]) * lam * carry
        advs[t] = carry
    return advs


def gae_plain(values, next_values, rewards, dones, gamma: float, lam: float):
    """``(normalised advantages, td targets)``, each of the inputs' shape
    ``(T, ...)``: the recursion runs over the leading (time) axis, each of
    the trailing entries (env column) on its own."""
    advs = _scan_plain(values, next_values, rewards, dones, gamma, lam)
    return normalize_plain(advs), advs + values


def gae_sharded_plain(values, next_values, rewards, dones, gamma: float,
                      lam: float, mesh=None):
    """``gae_plain`` over a horizon whose env columns are split over
    ``mesh``'s ranks (``ppo.py:136-145`` under an ``axis_name``): the
    rank's mean averaged over the ranks, the variance around it likewise,
    the std Bessel-corrected over every rank's entries.  ``gae_sharded``
    sends it CPU tensors (the CPU tests' path); at world 1 it gives
    ``gae_plain``'s numbers."""
    from ..parallel.mesh import pmean
    advs = _scan_plain(values, next_values, rewards, dones, gamma, lam)
    world = mesh.world if mesh is not None else 1
    m = pmean(advs.mean().reshape(1), mesh)
    var = pmean(torch.mean((advs - m) ** 2).reshape(1), mesh)
    n = advs.numel() * world
    std = sqrt_rn(var * n / max(n - 1, 1))
    return (advs - m) / (std + 1e-4), advs + values


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"gae: {name} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def gae_launch(values, next_values, rewards, dones, gamma: float,
               lam: float, adv, td, plan: GaePlan,
               kernel: KernelSource = KERNEL) -> None:
    """One launch of ``plan`` into ``adv`` and ``td`` (checked tensors),
    by ``kernel``'s build."""
    T, B = values.shape[0], values.shape[1]
    dev = values.device
    lib = _lib(kernel)
    err = lib.gae_launch(
        values.data_ptr(), next_values.data_ptr(), rewards.data_ptr(),
        dones.data_ptr(), T, B, gamma, lam, adv.data_ptr(), td.data_ptr(),
        MODES[plan.mode], plan.ctas, plan.cols, plan.threads, plan.rows,
        plan.stages,
        _scratch(dev).data_ptr() if plan.mode == "grid" else None,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "gae")


def gae(values, next_values, rewards, dones, gamma: float, lam: float):
    """GAE over a ``(T, B, 1)`` (or ``(T, B)``) horizon.  CPU tensors ->
    ``gae_plain``; CUDA tensors -> one kernel launch (float32, contiguous),
    or an error.  Returns ``(normalised advantages, td targets)`` of the
    inputs' shape."""
    if not values.is_cuda:
        return gae_plain(values, next_values, rewards, dones, gamma, lam)
    shape, dev = tuple(values.shape), values.device
    if len(shape) not in (2, 3) or (len(shape) == 3 and shape[2] != 1) \
            or shape[0] <= 0 or shape[1] <= 0:
        raise ValueError(f"gae: expected (T, B, 1) or (T, B), got {shape}")
    for name, t in (("values", values), ("next_values", next_values),
                    ("rewards", rewards), ("dones", dones)):
        _check(name, t, shape, dev)
    adv = torch.empty(shape, dtype=torch.float32, device=dev)
    td = torch.empty(shape, dtype=torch.float32, device=dev)
    gae_launch(values, next_values, rewards, dones, gamma, lam, adv, td,
               gae_plan(shape[0], shape[1]))
    gae.launches += 1
    return adv, td


gae.launches = 0


def sharded_launch(stage: str, values, next_values, rewards, dones,
                   gamma: float, lam: float, adv, td, mean, var,
                   plan: GaePlan, world: int = 1) -> None:
    """One launch of the sharded route on checked tensors: ``"mean"`` (A:
    td, the raw advantages into ``adv``, the rank's mean into ``mean``),
    ``"var"`` (B: the rank's variance of ``adv`` around ``mean`` into
    ``var``) or ``"norm"`` (C: ``adv`` normalised in place, the std
    Bessel-corrected over ``world`` ranks' entries); A and B by ``plan``."""
    T, B = values.shape[0], values.shape[1]
    dev = values.device
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if stage == "norm":
        err = lib.gae_norm_launch(adv.data_ptr(), T * B, mean.data_ptr(),
                                  var.data_ptr(), T * B * world, stream)
    else:
        err = lib.gae_stage_launch(
            values.data_ptr(), next_values.data_ptr(), rewards.data_ptr(),
            dones.data_ptr(), T, B, gamma, lam, adv.data_ptr(),
            td.data_ptr(), MODES[plan.mode], plan.ctas, plan.cols,
            plan.threads, plan.rows, plan.stages,
            _scratch(dev).data_ptr() if plan.mode == "grid" else None,
            1 if stage == "mean" else 2, mean.data_ptr(), var.data_ptr(),
            stream)
    check(err, lib, f"gae_sharded ({stage})")


def gae_sharded(values, next_values, rewards, dones, gamma: float,
                lam: float, mesh=None):
    """GAE over this rank's ``(T, B, 1)`` (or ``(T, B)``) share of a
    horizon split by env columns over ``mesh``'s ranks (None: one rank).
    CPU tensors -> ``gae_sharded_plain``; CUDA tensors -> launches A and B
    of ``gae_plan(T, B)``'s plan and C, around the mean's and the
    variance's all-reduces (``parallel/mesh.py::pmean``), or an error.
    Counts each launch in ``launches`` and in ``by_stage``
    (``SHARDED_STAGES``).  Returns ``(normalised advantages, td targets)``
    of the inputs' shape."""
    if not values.is_cuda:
        return gae_sharded_plain(values, next_values, rewards, dones, gamma,
                                 lam, mesh)
    from ..parallel.mesh import pmean
    shape, dev = tuple(values.shape), values.device
    if len(shape) not in (2, 3) or (len(shape) == 3 and shape[2] != 1) \
            or shape[0] <= 0 or shape[1] <= 0:
        raise ValueError(f"gae_sharded: expected (T, B, 1) or (T, B), got "
                         f"{shape}")
    for name, t in (("values", values), ("next_values", next_values),
                    ("rewards", rewards), ("dones", dones)):
        _check(name, t, shape, dev)
    adv = torch.empty(shape, dtype=torch.float32, device=dev)
    td = torch.empty(shape, dtype=torch.float32, device=dev)
    mean = torch.empty(1, dtype=torch.float32, device=dev)
    var = torch.empty(1, dtype=torch.float32, device=dev)
    plan = gae_plan(shape[0], shape[1])
    world = mesh.world if mesh is not None else 1
    for stage, stat in zip(SHARDED_STAGES, (mean, var, None)):
        sharded_launch(stage, values, next_values, rewards, dones, gamma,
                       lam, adv, td, mean, var, plan, world)
        gae_sharded.launches += 1
        gae_sharded.by_stage[stage] += 1
        if stat is not None:
            pmean(stat, mesh)
    return adv, td


gae_sharded.launches = 0
gae_sharded.by_stage = {s: 0 for s in SHARDED_STAGES}
