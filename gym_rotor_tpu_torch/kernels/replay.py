"""K2 + K8: the replay ring's write (with the episode statistics in the same
launch) and read.

Replaces ``gym_rotor_tpu/algos/replay.py:145`` ``insert_tick`` (``_pack``
and ``insert``'s modular scatter), ``:199`` ``sample`` (with the copies the
learners made of the sampled fields: ``concat(obs, act)`` for the critic,
the CTDE joint obs and actions, the CAPS stacks, ``gym_rotor_tpu/algos/
td3.py:209-224``, ``:284``, ``sac.py:153-171``, ``:242``), and the episode
bookkeeping of ``gym_rotor_tpu/parallel/train_step.py:142-155``
(``roll_body``), which XLA fused into the rollout scan and the update on
the TPU.  Kernels: ``csrc/replay.cu``.  Plain twins:
``replay_insert_tick_plain`` and ``replay_sample_plain``, which are what
run on CPU tensors.

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

The read (``replay_sample``) gathers the sampled rows straight into the
operands the learners read, one buffer laid out by a ``GatherLayout``
(built once per ``(dims, ctde, stack)`` and cached): per agent the critic
input ``[obs_i | act_i]`` (under CTDE one joint ``[obs_0 | obs_1 | act_0 |
act_1]``, and the target's joint ``[next_obs_0 | next_obs_1]``), the CAPS
stack (its row blocks from the ring, ``obs`` and ``next_obs`` as the
learner stacks them, and a last block left for ``obs + eps``), and
``rwd_i``, ``done_i``.  Each operand is a contiguous ``(k B, width)``
matrix; each row block of one is a region, whose columns come from ring
columns (the column map).  A value is a copy of its ring element, times
NaN when the ring is empty (the poison), so every operand is bitwise the
parent's sliced fields and their concatenations.

What bounds it on an H100: the bytes (~1.5 MB per flagship tick, ~0.45 us;
a 256-row sample reads ~46 KB of ring rows and writes ~80-120 KB of
operands, ~0.05 us); at 32 rows the launch.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

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
        lib.replay_sample_launch.argtypes = [P, I, P, I, F, P, I, P, P]
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


class GatherLayout:
    """Where one sample writes the sampled ring columns: the learners'
    operands as contiguous matrices in one buffer of ``per_row * B``
    floats (``B`` sampled rows).

    Operands, in buffer order: ``sa<i>`` per agent, ``[obs_i | act_i]``
    (B, d_i + a_i), or under ``ctde`` one ``sa``, ``[obs_0 | .. | act_0 |
    ..]``, and ``t_obs``, ``[next_obs_0 | ..]``; ``stack<i>`` per agent,
    ``len(stack)`` row blocks of (B, d_i), block ``q`` the ring field
    ``stack[q]`` (``"obs"`` or ``"next_obs"``), or left unwritten where it
    is ``"eps"`` (the learner writes ``obs + eps`` there); ``rwd<i>`` and
    ``done<i>`` (B, 1).  ``stack`` holds ``"obs"`` and ``"next_obs"``:
    the batch's ``obs`` and ``next_obs`` fields are views of their first
    blocks."""

    def __init__(self, dims: Dims, ctde: bool, stack: Tuple[str, ...]):
        obs_dims, act_dims = (tuple(int(d) for d in x) for x in dims)
        n = len(obs_dims)
        if "obs" not in stack or "next_obs" not in stack \
                or not set(stack) <= {"obs", "next_obs", "eps"}:
            raise ValueError(f"GatherLayout: bad stack {stack}")
        self.dims, self.ctde, self.stack = (obs_dims, act_dims), ctde, stack
        cmap = column_map((obs_dims, act_dims))
        start = {}
        for c, code in enumerate(cmap.tolist()):
            start.setdefault((code >> 8, code & 0xFF), c)

        def run(field, c0, w):
            return list(range(start[(field, c0)], start[(field, c0)] + w))

        def obs(a):
            return run(a, 0, obs_dims[a])

        def nobs(a):
            return run(4 + a, 0, obs_dims[a])
        act0 = [sum(act_dims[:a]) for a in range(n)]

        def act(a):
            return run(2, act0[a], act_dims[a])
        ops: List[Tuple[str, List[Optional[List[int]]]]] = []
        if ctde:
            ops.append(("sa", [sum((obs(a) for a in range(n)), [])
                               + sum((act(a) for a in range(n)), [])]))
            ops.append(("t_obs", [sum((nobs(a) for a in range(n)), [])]))
        else:
            ops += [(f"sa{a}", [obs(a) + act(a)]) for a in range(n)]
        for a in range(n):
            ops.append((f"stack{a}", [
                None if f == "eps" else (obs(a) if f == "obs" else nobs(a))
                for f in stack]))
        for a in range(n):
            ops.append((f"rwd{a}", [[start[(3, a)]]]))
            ops.append((f"done{a}", [[start[(6, a)]]]))
        # operands: name -> (offset in per-row units, rows in B, width);
        # regions: (gathered offset, buffer offset, width, column-map base),
        # both offsets in per-row units (times B in the buffer)
        self.operands: Dict[str, Tuple[int, int, int]] = {}
        self.regions: List[Tuple[int, int, int, int]] = []
        self.cols: List[int] = []
        u = g = 0
        for name, blocks in ops:
            w = len(next(b for b in blocks if b is not None))
            self.operands[name] = (u, len(blocks), w)
            for q, cols in enumerate(blocks):
                if cols is not None:
                    self.regions.append((g, u + q * w, w, len(self.cols)))
                    self.cols += cols
                    g += w
            u += len(blocks) * w
        self.per_row, self.gathered = u, g
        self._index: Dict[str, List[torch.Tensor]] = {}
        self._table: Dict[str, torch.Tensor] = {}

    def words(self) -> np.ndarray:
        """The kernel's column map: for each gathered column of a sampled
        row (region by region), one int64 of four 16-bit fields, its ring
        column, its region's buffer offset (per-row units), the region's
        width and the column's place in the region."""
        out = []
        for _, o, w, cb in self.regions:
            out += [src | o << 16 | w << 32 | c << 48
                    for c, src in enumerate(self.cols[cb:cb + w])]
        return np.asarray(out, np.int64)

    def table(self, device) -> torch.Tensor:
        """``words`` on ``device``, cached."""
        key = str(device)
        if key not in self._table:
            if max(self.per_row, max(self.cols) + 1) >= 1 << 15:
                raise ValueError("GatherLayout: rows too wide for the map")
            self._table[key] = torch.from_numpy(self.words()).to(device)
        return self._table[key]

    def index(self, device) -> List[torch.Tensor]:
        """Per region, its ring columns as an int64 tensor on ``device``."""
        key = str(device)
        if key not in self._index:
            self._index[key] = [
                torch.tensor(self.cols[cb:cb + w], dtype=torch.int64,
                             device=device)
                for _, _, w, cb in self.regions]
        return self._index[key]

    def written(self, buf: torch.Tensor, B: int) -> List[torch.Tensor]:
        """The regions' (B, width) views of a sample's buffer: everything a
        sample writes (the ``"eps"`` blocks are not)."""
        return [buf[o * B:(o + w) * B].view(B, w)
                for _, o, w, _ in self.regions]

    def views(self, buf: torch.Tensor, B: int) -> Dict[str, torch.Tensor]:
        """Every operand's (rows, width) view of a sample's buffer."""
        return {name: buf[u * B:(u + k * w) * B].view(k * B, w)
                for name, (u, k, w) in self.operands.items()}


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


def replay_sample_plain(data, idx, poison: bool, layout: GatherLayout):
    """The gather as torch ops: ``data[idx]`` (times NaN when ``poison``),
    its columns copied into the layout's regions of a new buffer."""
    rows = data[idx]
    rows = rows * float("nan") if poison else rows * 1.0
    B = rows.shape[0]
    buf = torch.empty(B * layout.per_row, dtype=data.dtype,
                      device=data.device)
    for dst, cols in zip(layout.written(buf, B), layout.index(data.device)):
        dst.copy_(rows[:, cols])
    return buf


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


def replay_sample(data, idx, poison: bool, layout: GatherLayout):
    """The rows ``data[idx]`` (all NaN when ``poison``, the empty ring)
    gathered into the operands of ``layout``: a buffer of ``per_row * B``
    floats (``layout.views`` reads it).  CPU tensors ->
    ``replay_sample_plain``; CUDA tensors -> one launch (float32 ring,
    int64 indices; one gathered element a thread), or an error."""
    if not data.is_cuda:
        return replay_sample_plain(data, idx, poison, layout)
    cap, rd = data.shape
    batch, dev = idx.shape[0], data.device
    _check("ring", data, torch.float32, (cap, rd), dev)
    _check("idx", idx, torch.int64, (batch,), dev)
    if batch <= 0 or batch * layout.per_row >= 2 ** 31:
        raise ValueError(f"replay_sample: {batch} rows")
    out = torch.empty(batch * layout.per_row, dtype=torch.float32,
                      device=dev)
    lib = _lib()
    err = lib.replay_sample_launch(
        data.data_ptr(), rd, idx.data_ptr(), batch,
        float("nan") if poison else 1.0, layout.table(dev).data_ptr(),
        layout.gathered, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "replay_sample")
    replay_sample.launches += 1
    return out


replay_sample.launches = 0
