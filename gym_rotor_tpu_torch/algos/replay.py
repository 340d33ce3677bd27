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

A sample writes the learners' operands directly (``kernels/replay.py``
``GatherLayout``): the critic input ``[obs_i | act_i]`` (under CTDE the
joint obs and actions, and the joint ``next_obs``), the CAPS stack with
its last block free for ``obs + eps``, ``rwd_i`` and ``done_i``; the
``Batch`` fields are views of them, and ``Batch.ops`` carries them to the
learners (``learner_operands``; only a ``Batch`` built by hand has its
fields concatenated).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
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


class Operands(NamedTuple):
    """The learners' operands a sample wrote (views of one buffer):
    ``sa`` per agent ``[obs_i | act_i]`` (under CTDE each agent's entry is
    the one joint ``[obs_0 | obs_1 | act_0 | act_1]``), ``t_obs`` the CTDE
    joint ``next_obs`` (None under DTDE), and per agent the CAPS ``stack``
    of (``len(fields)`` B, d_i), its row blocks the ring fields ``fields``
    (``"eps"``: a block left for the learner)."""
    sa: Tuple[torch.Tensor, ...]
    t_obs: Optional[torch.Tensor]
    stack: Tuple[torch.Tensor, ...]
    fields: Tuple[str, ...]


class Batch(NamedTuple):
    obs: Tuple[torch.Tensor, ...]
    act: Tuple[torch.Tensor, ...]
    rwd: Tuple[torch.Tensor, ...]
    next_obs: Tuple[torch.Tensor, ...]
    done: Tuple[torch.Tensor, ...]
    ops: Optional[Operands] = None


# the stack a sample writes when no learner names one: obs and next_obs
PLAIN_STACK = ("obs", "next_obs")


@lru_cache(maxsize=None)
def gather_layout(dims, ctde: bool, stack: Tuple[str, ...]) -> K.GatherLayout:
    """The cached ``GatherLayout`` of ``(dims, ctde, stack)``."""
    return K.GatherLayout(dims, ctde, stack)


def sample(rs: ReplayState, batch_size: int,
           generator: Optional[torch.Generator] = None,
           idx: Optional[torch.Tensor] = None, ctde: bool = False,
           stack: Tuple[str, ...] = PLAIN_STACK) -> Batch:
    """Uniform shared indices over ``[0, max(filled, 1))``, with
    replacement (``idx`` injects them); one gather into the learners'
    operands (``ctde``: the joint ones; ``stack``: the CAPS stack's row
    blocks, ``kernels/replay.py::GatherLayout``), the fields views of them.
    A batch drawn while the ring is empty is NaN-poisoned."""
    if idx is None:
        idx = torch.randint(0, max(rs.filled, 1), (batch_size,),
                            generator=generator, device=rs.data.device)
    layout = gather_layout(rs.dims, bool(ctde), tuple(stack))
    B = idx.shape[0]
    buf = K.replay_sample(rs.data, idx.to(rs.data.device), rs.filled == 0,
                          layout)
    v = layout.views(buf, B)
    obs_dims, act_dims = rs.dims
    n = len(obs_dims)
    q_obs, q_next = stack.index("obs"), stack.index("next_obs")
    stacks = tuple(v[f"stack{a}"] for a in range(n))
    if ctde:
        sa, t_obs = (v["sa"],) * n, v["t_obs"]
        c0 = [sum(obs_dims) + sum(act_dims[:a]) for a in range(n)]
    else:
        sa, t_obs = tuple(v[f"sa{a}"] for a in range(n)), None
        c0 = list(obs_dims)
    return Batch(
        obs=tuple(s[q_obs * B:(q_obs + 1) * B] for s in stacks),
        act=tuple(x[:, c:c + d] for x, c, d in zip(sa, c0, act_dims)),
        rwd=tuple(v[f"rwd{a}"] for a in range(n)),
        next_obs=tuple(s[q_next * B:(q_next + 1) * B] for s in stacks),
        done=tuple(v[f"done{a}"] for a in range(n)),
        ops=Operands(sa, t_obs, stacks, tuple(stack)))


def learner_operands(batch: Batch, i: int, ctde: bool,
                     stack: Optional[Tuple[str, ...]] = None):
    """Agent ``i``'s ``(sa, t_obs, stack)``: the critic input ``[obs_i |
    act_i]`` (``ctde``: the joint one), the CTDE joint ``next_obs`` (None
    under DTDE) and, when ``stack`` names its fields, the CAPS stack with
    its ``"eps"`` block unwritten.  The operands the sample wrote; a
    ``Batch`` built by hand (no ``ops``) gets concatenations of its fields,
    the same values.  Raises ``ValueError`` where the sample wrote another
    layout than the learner asks for."""
    ops = batch.ops
    if ops is not None:
        if (ops.t_obs is not None) != ctde or (
                stack and ops.fields != tuple(stack)):
            raise ValueError(
                f"learner_operands: the sample wrote the layout (ctde="
                f"{ops.t_obs is not None}, stack={ops.fields}), the learner "
                f"asks for (ctde={ctde}, stack={stack})")
        return ops.sa[i], ops.t_obs, ops.stack[i] if stack else None
    if ctde:
        sa = torch.cat(list(batch.obs) + list(batch.act), dim=-1)
        t_obs = torch.cat(batch.next_obs, dim=-1)
    else:
        sa, t_obs = torch.cat([batch.obs[i], batch.act[i]], dim=-1), None
    if not stack:
        return sa, t_obs, None
    obs = batch.obs[i]
    B = obs.shape[0]
    stk = obs.new_empty((len(stack) * B,) + tuple(obs.shape[1:]))
    for q, f in enumerate(stack):
        if f != "eps":
            stk[q * B:(q + 1) * B] = getattr(batch, f)[i]
    return sa, t_obs, stk
