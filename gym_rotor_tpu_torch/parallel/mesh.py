"""The process group and the data-parallel helpers (port of
``gym_rotor_tpu/parallel/mesh.py``).

The JAX package trains data-parallel over one ``env`` mesh axis: env state,
rollouts and the replay ring are sharded along the env/capacity axis, the
parameters are replicated and every gradient is ``pmean``-reduced inside
the update.  The port runs the same layout over a ``torch.distributed``
process group, one process a GPU:

    python -m torch.distributed.run --nproc_per_node 8 \\
        -m gym_rotor_tpu_torch.train [--flag value ...]

``initialize_distributed`` opens the group (``nccl`` on CUDA devices,
``gloo`` on the CPU) from ``torchrun``'s ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` or from its arguments; ``make_mesh`` describes it as a
``Mesh`` (a world of 1 and no group without one).  ``pmean`` / ``psum`` are
one ``all_reduce`` each, outside any kernel: JAX's ``pmean`` is an XLA
collective, not one of the fused programs the port's kernels replace.

``gloo`` on CUDA tensors: its ``all_reduce`` and ``broadcast`` take them
(the group copies through the host itself); its gather does not, so
``gather_rows`` stages through host memory explicitly under ``gloo``, and
nowhere else.  No helper changes a tensor's backend or device on its own.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """One process's view of the data-parallel world: its ``rank``, the
    ``world`` size, its ``device``, the process ``group`` (None without
    one) and the group's ``backend``."""
    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None
    backend: Optional[str] = None

    @property
    def sharded(self) -> bool:
        """More than one rank: the collectives run."""
        return self.world > 1

    def rows(self, n_global: int) -> slice:
        """This rank's contiguous share of ``n_global`` rows (which the
        world must divide)."""
        if n_global % self.world:
            raise ValueError(f"{n_global} rows do not split over "
                             f"{self.world} ranks")
        n = n_global // self.world
        return slice(self.rank * n, (self.rank + 1) * n)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def initialize_distributed(rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           local_rank: Optional[int] = None, device=None,
                           backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           store=None) -> bool:
    """Open the process group (``torch.distributed.init_process_group``).

    ``rank``, ``world_size`` and ``local_rank`` default to ``torchrun``'s
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; ``device`` to
    ``cuda:LOCAL_RANK`` (``"cpu"`` for the plain path); ``backend`` to
    ``nccl`` for a CUDA device and ``gloo`` for the CPU (``gloo`` on CUDA
    devices is the one way to put two ranks on one card, which ``nccl``
    refuses).  ``init_method`` defaults to ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``), or pass a ``store``.  A no-op, returning False, when
    the world is one process or a group is already open, as JAX's is at
    ``num_processes <= 1``; True when it opened one."""
    world_size = world_size if world_size is not None else \
        (_env_int("WORLD_SIZE") or 1)
    if world_size <= 1 or dist.is_initialized():
        return False
    rank = rank if rank is not None else (_env_int("RANK") or 0)
    local_rank = local_rank if local_rank is not None else \
        (_env_int("LOCAL_RANK") or 0)
    dev = resolve_device(f"cuda:{local_rank}" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, rank=rank, world_size=world_size)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method or "env://"
    dist.init_process_group(**kw)
    return True


def make_mesh(device=None) -> Mesh:
    """The ``Mesh`` of the open process group on ``device`` (default
    ``cuda:LOCAL_RANK``), or a world of one on ``device`` (default the
    card) without a group."""
    if dist.is_available() and dist.is_initialized():
        dev = resolve_device(device if device is not None else
                             f"cuda:{_env_int('LOCAL_RANK') or 0}")
        return Mesh(dist.get_rank(), dist.get_world_size(), dev,
                    dist.group.WORLD, dist.get_backend())
    return Mesh(0, 1, resolve_device(device))


def psum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` summed over the ranks, in place (one ``all_reduce``); a no-op
    without a mesh or at world 1."""
    if mesh is None or not mesh.sharded:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def pmean(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` averaged over the ranks, in place: one ``all_reduce(SUM)``,
    then a division by the world size (JAX's ``pmean`` divides the sum);
    a no-op without a mesh or at world 1."""
    if mesh is None or not mesh.sharded:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x.div_(mesh.world)


def shard_batch(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's contiguous rows of a global ``(B, ...)`` tensor (a
    copy), the rank-order split of JAX's ``P(axis)`` sharding."""
    if mesh is None or not mesh.sharded:
        return x
    return x[mesh.rows(x.shape[0])].clone()


def replicate(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]):
    """Make ``tensors`` rank 0's on every rank (in place, one
    ``broadcast`` each); returns them."""
    if mesh is not None and mesh.sharded:
        for t in tensors:
            dist.broadcast(t, src=0, group=mesh.group)
    return tensors


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along dim
    0 in rank order, on every rank: the global array of JAX's ``P(axis)``
    sharding.  One ``all_gather`` into the output's rank chunks under
    either backend; under ``gloo`` it runs on host copies (its gather takes
    no CUDA tensor) and the result is moved back to ``x``'s device, under
    ``nccl`` on the device.  Booleans travel as uint8."""
    if mesh is None or not mesh.sharded:
        return x
    src = x.contiguous()
    as_bool = src.dtype == torch.bool
    if as_bool:
        src = src.to(torch.uint8)
    staged = mesh.backend == "gloo" and src.is_cuda
    if staged:
        src = src.cpu()
    out = torch.empty((mesh.world * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather(list(out.chunk(mesh.world)), src, group=mesh.group)
    if staged:
        out = out.to(x.device)
    return out.bool() if as_bool else out


def gather_objects(obj, mesh: Optional[Mesh]) -> list:
    """Every rank's picklable ``obj``, in rank order (``[obj]`` at world
    1)."""
    if mesh is None or not mesh.sharded:
        return [obj]
    out = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (a no-op at world 1)."""
    if mesh is not None and mesh.sharded:
        if mesh.backend == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)


def rank_seed(seed: int, rank: int) -> int:
    """The generator seed of rank ``rank`` (the counterpart of JAX's
    ``fold_in(key, axis_index)``): ``seed`` itself on rank 0, so a world
    of one draws today's stream; on rank ``r > 0`` a 63-bit seed derived
    from ``(seed, r)`` by NumPy's ``SeedSequence``."""
    if rank == 0:
        return int(seed)
    import numpy as np
    return int(np.random.SeedSequence([int(seed), int(rank)])
               .generate_state(2, np.uint64)[0] >> np.uint64(1))
