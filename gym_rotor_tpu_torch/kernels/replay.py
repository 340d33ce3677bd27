"""K2 + K8: the replay ring's write (with the episode statistics in the same
launch) and read.

Replaces ``gym_rotor_tpu/algos/replay.py:145`` ``insert_tick`` (``_pack``
and ``insert``'s modular scatter), ``:199`` ``sample``, and the episode
bookkeeping of ``gym_rotor_tpu/parallel/train_step.py:142-155``
(``roll_body``), which XLA fused into the rollout scan on the TPU.
Kernels: ``csrc/replay.cu``.  Plain twins: ``replay_insert_tick_plain``
and ``replay_sample_plain``, which are what run on CPU tensors.

Ring row layout (``algos/replay.py``): ``[obs_0, obs_1 | joint action |
rwd_0, rwd_1 | next_obs_0, next_obs_1 | done_0, done_1]``.  The write
stores ``B`` rows at ``(ptr + b) % capacity`` in place (JAX returns a new
ring; at 1e6 rows a copy per tick is what the port avoids) and, when
``ep_ret`` is given, carries the per-env episodic returns and adds the
tick's finished-return sums, finished count and reward sum into ``stats``
(``[fin_0, .., fin_{n-1}, count, reward sum]``), all in one launch.  The
cross-env sums are per-tile sums (32 rows a tile, summed by a fixed
butterfly of shuffles) that the block finishing last adds in a fixed order
(each of 32 lanes a run of tiles in tile order, then the butterfly), so a
run repeats its numbers bitwise; ``tests/test_torch_replay_kernel.py``
emulates that order and holds it to the plain twin and to JAX.  The blocks
find the last one by a ticket: an atomic counter per device (``_ticket``),
which that block re-arms to zero, so launches on one device run one after
another (one stream) as the train paths launch them.

What bounds it on an H100: the bytes (~1.5 MB per flagship tick, ~0.45 us;
a 256-row sample ~0.1 MB); at 32 rows the launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .build import KernelSource, check

KERNEL = KernelSource("replay", [])
WRAPPERS = {"replay_insert_tick": "replay_insert_tick_plain",
            "replay_sample": "replay_sample_plain"}

Dims = Tuple[Tuple[int, ...], Tuple[int, ...]]


def _lib():
    lib = KERNEL.load()
    if not getattr(lib, "_typed", False):
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.replay_insert_launch.argtypes = [P, L, I, L, I, P, I, P, I, P, I,
                                             P, P, P, P, I, P, P, P, P, P, P]
        lib.replay_insert_launch.restype = I
        lib.replay_sample_launch.argtypes = [P, I, P, I, F, P, P]
        lib.replay_sample_launch.restype = I
        lib.replay_insert_blocks.argtypes = [I]
        lib.replay_insert_blocks.restype = I
        lib._typed = True
    return lib


def column_map(dims: Dims) -> np.ndarray:
    """Per ring column, ``field << 8 | column`` of its source: fields 0/1
    ``obs_0``/``obs_1``, 2 the joint action, 3 the rewards, 4/5
    ``next_obs_0``/``next_obs_1``, 6 the done flags.  The kernel finds the
    same from the field widths it is launched with."""
    obs_dims, act_dims = dims
    n = len(obs_dims)
    out = []
    for a, d in enumerate(obs_dims):
        out += [(a << 8) | c for c in range(d)]
    out += [(2 << 8) | c for c in range(sum(act_dims))]
    out += [(3 << 8) | a for a in range(n)]
    for a, d in enumerate(obs_dims):
        out += [((4 + a) << 8) | c for c in range(d)]
    out += [(6 << 8) | a for a in range(n)]
    return np.asarray(out, np.int32)


_TICKETS = {}


def _ticket(device) -> torch.Tensor:
    """The device's ticket counter for the statistics' last-block sum: one
    zeroed int32, left zeroed by every launch."""
    key = str(device)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _TICKETS[key]


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------
def pack_rows(obs_t: Sequence[torch.Tensor], actions, reward,
              next_obs_t: Sequence[torch.Tensor], done, dtype):
    """``_pack``: the tick's rows in ring layout, cast to the ring dtype."""
    cols = list(obs_t) + [actions, reward] + list(next_obs_t) + [done]
    return torch.cat([c.to(dtype) for c in cols], dim=-1)


def replay_insert_tick_plain(data, ptr: int, dims: Dims, obs_t, actions,
                             reward, next_obs_t, done, reset=None,
                             ep_ret=None, stats=None) -> None:
    rows = pack_rows(obs_t, actions, reward, next_obs_t, done, data.dtype)
    k, cap = rows.shape[0], data.shape[0]
    idx = (ptr + torch.arange(k, device=data.device)) % cap
    data[idx] = rows
    if ep_ret is None:
        return
    n = len(dims[0])
    ep = ep_ret + reward
    stats[:n] += torch.where(reset[:, None], ep, 0.0).sum(0)
    stats[n] += reset.to(stats.dtype).sum()
    stats[n + 1] += reward.sum()
    ep_ret.copy_(torch.where(reset[:, None], 0.0, ep))


def replay_sample_plain(data, idx, poison: bool):
    rows = data[idx]
    return rows * float("nan") if poison else rows * 1.0


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"replay: {name} must be a contiguous {dtype} "
                         f"{shape} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def replay_insert_tick(data, ptr: int, dims: Dims, obs_t, actions, reward,
                       next_obs_t, done, reset: Optional[torch.Tensor] = None,
                       ep_ret: Optional[torch.Tensor] = None,
                       stats: Optional[torch.Tensor] = None) -> None:
    """Write ``B = actions.shape[0]`` rows into ``data`` at ``(ptr + b) %
    capacity`` and, with ``reset``/``ep_ret``/``stats``, the episode
    statistics (module docstring).  CPU tensors ->
    ``replay_insert_tick_plain``; CUDA tensors -> one launch of the kernel
    (float32; 32-row tiles, the statistics' tile partials added by the
    last block), or an error."""
    if not data.is_cuda:
        return replay_insert_tick_plain(data, ptr, dims, obs_t, actions,
                                        reward, next_obs_t, done, reset,
                                        ep_ret, stats)
    obs_dims, act_dims = dims
    n, B, dev = len(obs_dims), actions.shape[0], data.device
    cap, rd = data.shape
    if n not in (1, 2) or B <= 0 or B > cap:
        raise ValueError(f"replay_insert_tick: {n} agents and {B} rows into "
                         f"a ring of {cap}")
    f32 = torch.float32
    _check("ring", data, f32, (cap, rd), dev)
    for a in range(n):
        _check(f"obs_{a}", obs_t[a], f32, (B, obs_dims[a]), dev)
        _check(f"next_obs_{a}", next_obs_t[a], f32, (B, obs_dims[a]), dev)
    _check("actions", actions, f32, (B, sum(act_dims)), dev)
    _check("reward", reward, f32, (B, n), dev)
    _check("done", done, torch.bool, (B, n), dev)
    with_stats = ep_ret is not None
    lib = _lib()
    partial = ticket = None
    if with_stats:
        _check("reset", reset, torch.bool, (B,), dev)
        _check("ep_ret", ep_ret, f32, (B, n), dev)
        _check("stats", stats, f32, (n + 2,), dev)
        partial = torch.empty(lib.replay_insert_blocks(B) * (n + 2),
                              dtype=f32, device=dev)
        ticket = _ticket(dev)

    def ptr_of(t):
        return None if t is None else t.data_ptr()
    o1 = obs_t[1] if n == 2 else None
    no1 = next_obs_t[1] if n == 2 else None
    err = lib.replay_insert_launch(
        data.data_ptr(), cap, rd, ptr % cap, B,
        obs_t[0].data_ptr(), obs_dims[0], ptr_of(o1),
        obs_dims[1] if n == 2 else 0, actions.data_ptr(), sum(act_dims),
        reward.data_ptr(), next_obs_t[0].data_ptr(), ptr_of(no1),
        done.data_ptr(), n, ptr_of(reset) if with_stats else None,
        ptr_of(ep_ret),
        ptr_of(partial), ptr_of(stats) if with_stats else None,
        ptr_of(ticket), torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "replay_insert_tick")
    replay_insert_tick.launches += 1


replay_insert_tick.launches = 0


def replay_sample(data, idx, poison: bool):
    """``(batch, row_dim)`` rows ``data[idx]``, all NaN when ``poison`` (the
    empty ring).  CPU tensors -> ``replay_sample_plain``; CUDA tensors ->
    one launch (float32 ring, int64 indices), or an error."""
    if not data.is_cuda:
        return replay_sample_plain(data, idx, poison)
    cap, rd = data.shape
    batch, dev = idx.shape[0], data.device
    _check("ring", data, torch.float32, (cap, rd), dev)
    _check("idx", idx, torch.int64, (batch,), dev)
    if batch <= 0:
        raise ValueError("replay_sample: empty batch")
    out = torch.empty(batch, rd, dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.replay_sample_launch(
        data.data_ptr(), rd, idx.data_ptr(), batch,
        float("nan") if poison else 1.0, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "replay_sample")
    replay_sample.launches += 1
    return out


replay_sample.launches = 0
