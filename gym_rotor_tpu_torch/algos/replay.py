"""Device replay ring (port of ``gym_rotor_tpu/algos/replay.py``).

One row-major ``(capacity, row_dim)`` ring with a write cursor, shared by
all agents: ``[obs_0, obs_1 | act_0, act_1 | rwd_0, rwd_1 | next_obs_0,
next_obs_1 | done_0, done_1]`` (45 floats a row for MODUL).  Writes and
reads go through K2 (``kernels/replay.py``): on the card one kernel launch
per tick (with the episode statistics, K8, in the same launch) and one per
sample; on the CPU the plain twins.

Divergences from the JAX module, both deliberate: the ring is written in
place (JAX returns a new array; a copy of a 1e6-row ring per tick is what
this avoids), and ``ptr``/``filled`` are host integers, the mirror of the
JAX device scalars, so drawing the sample indices and the empty-ring
poison cost no device sync.  Samples are drawn with replacement, as in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..kernels import replay as K
from ..utils.device import resolve_device


@dataclass
class ReplayState:
    data: torch.Tensor          # (capacity, row_dim)
    ptr: int                    # write cursor
    filled: int                 # number of valid rows
    dims: Tuple[Tuple[int, ...], Tuple[int, ...]] = ((), ())

    def _field(self, which: int):
        """Per-agent column views of field ``which`` in [obs, act, rwd,
        next_obs, done]."""
        return _split(self.data, self.dims)[which]

    @property
    def obs(self):
        return self._field(0)

    @property
    def act(self):
        return self._field(1)

    @property
    def rwd(self):
        return self._field(2)

    @property
    def next_obs(self):
        return self._field(3)

    @property
    def done(self):
        return self._field(4)


def _split(rows: torch.Tensor, dims):
    obs_dims, act_dims = dims
    n = len(obs_dims)
    sizes = (list(obs_dims) + list(act_dims) + [1] * n + list(obs_dims)
             + [1] * n)
    cols = torch.split(rows, sizes, dim=-1)
    return tuple(tuple(cols[f * n:(f + 1) * n]) for f in range(5))


def row_dim(obs_dims: Sequence[int], act_dims: Sequence[int]) -> int:
    n = len(obs_dims)
    return 2 * sum(obs_dims) + sum(act_dims) + 2 * n


def create(capacity: int, obs_dims: Sequence[int], act_dims: Sequence[int],
           dtype=torch.float32, device=None) -> ReplayState:
    """An empty ring; entry point: on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    return ReplayState(
        data=torch.zeros(capacity, row_dim(obs_dims, act_dims), dtype=dtype,
                         device=dev),
        ptr=0, filled=0,
        dims=(tuple(int(d) for d in obs_dims), tuple(int(d) for d in act_dims)))


def _advance(rs: ReplayState, k: int) -> ReplayState:
    cap = rs.data.shape[0]
    rs.ptr = (rs.ptr + k) % cap
    rs.filled = min(rs.filled + k, cap)
    return rs


def insert_tick(rs: ReplayState, obs_t: tuple, actions, reward,
                next_obs_t: tuple, done, reset: Optional[torch.Tensor] = None,
                ep_ret: Optional[torch.Tensor] = None,
                stats: Optional[torch.Tensor] = None) -> ReplayState:
    """Insert one lockstep tick (B rows): per-agent ``obs_t``/``next_obs_t``
    (B, d), the joint ``actions``, ``reward``/``done`` (B, n_agents).  With
    ``reset`` (B,), ``ep_ret`` (B, n_agents) and ``stats`` (n_agents + 2,)
    the same launch carries the episode statistics (``kernels/replay.py``).
    Returns ``rs``, updated in place."""
    K.replay_insert_tick(rs.data, rs.ptr, rs.dims, tuple(obs_t), actions,
                         reward, tuple(next_obs_t), done, reset, ep_ret,
                         stats)
    return _advance(rs, actions.shape[0])


def insert(rs: ReplayState, obs_n, act_n, rwd_n, next_obs_n, done_n
           ) -> ReplayState:
    """Insert a block of k transitions per agent (k <= capacity)."""
    return insert_tick(rs, tuple(obs_n), torch.cat(list(act_n), dim=-1),
                       torch.stack(list(rwd_n), dim=-1), tuple(next_obs_n),
                       torch.stack(list(done_n), dim=-1))


def insert_rollout(rs: ReplayState, trs) -> ReplayState:
    """Insert a time-major ``Transition`` stack ((T, B, ...) per agent)."""
    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))
    n = len(rs.dims[0])
    return insert_tick(rs, tuple(flat(trs.obs[i]) for i in range(n)),
                       flat(trs.action), flat(trs.reward),
                       tuple(flat(trs.next_obs[i]) for i in range(n)),
                       flat(trs.done))


class Batch(NamedTuple):
    obs: Tuple[torch.Tensor, ...]
    act: Tuple[torch.Tensor, ...]
    rwd: Tuple[torch.Tensor, ...]
    next_obs: Tuple[torch.Tensor, ...]
    done: Tuple[torch.Tensor, ...]


def sample(rs: ReplayState, batch_size: int,
           generator: Optional[torch.Generator] = None,
           idx: Optional[torch.Tensor] = None) -> Batch:
    """Uniform shared indices over ``[0, max(filled, 1))``, with
    replacement (``idx`` injects them); one row gather, sliced into
    per-agent fields.  A batch drawn while the ring is empty is
    NaN-poisoned."""
    if idx is None:
        idx = torch.randint(0, max(rs.filled, 1), (batch_size,),
                            generator=generator, device=rs.data.device)
    rows = K.replay_sample(rs.data, idx.to(rs.data.device), rs.filled == 0)
    return Batch(*_split(rows, rs.dims))

