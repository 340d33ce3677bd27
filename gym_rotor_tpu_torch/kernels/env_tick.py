"""K1: the fused env tick, one CUDA launch per lockstep tick.

Replaces ``gym_rotor_tpu/envs/batch.py:batched_step`` (with
``trajectory.get_desired``, ``quad.step``, ``dynamics.{euler,rk4,dop853}_step``,
``so3.polar_fast`` or ``so3.ensure_so3_exact`` and ``quad.reset_state``
inlined), which XLA fused into one program on the TPU.  Kernel:
``csrc/env_tick.cu``.  Plain twin: ``envs/batch.py:batched_step_plain``
(re-exported here as ``env_tick_plain``), which is what runs on CPU tensors.

What bounds it on an H100: per env a tick reads and writes ~0.5 KB of state
and does a few thousand dependent flops (DOP853: 12 evaluations of the
equations of motion against RK4's 4), so at B = 4096 the work is ~5 MB and
~30-90 MFLOP, about 1.5 us of HBM time; the launch itself (a few us) and
the serial per-thread chain dominate.  The design keeps everything else out
of the way: one thread per env, the whole tick (goal, action, integrator,
attitude repair, obs, reward, cap/solved override, fresh episode, select)
in registers in one launch, state in field-major buffers where each field
is a contiguous ``(B, w)`` block, and the fresh-episode chain run only by
the threads whose episode ended (the JAX tick computes it densely for every
env only to keep XLA's fusion whole).

Twelve instances of the kernel are built: the MODUL ``decoupled`` and the
MONO ``coupled`` task (``quad.py:91-93, 178-184, 206-216, 247-255``), each
with the Euler, RK4 and DOP853 integrators, each with and without
``exact_so3``; the trajectory mode (``cfg.train_traj_mode``, any int) is a
runtime argument.  On the card the state lives in three flat buffers
(float32, int32, bool), the same for every instance; the tick's outputs in
two more (float32, bool) whose slots differ per task (``OUT``).  The
offsets of both, the draw slots and DOP853's tableau are written into
``env_tick_layout.h`` at build time from the Python side, so the two
sides cannot disagree.  The kernel reads
one set of buffers and writes another: ``env_tick`` stays functional, as in
JAX (it packs a copy of the state and returns views of new buffers), and
``TickLoop``, which the rollouts use, carries two buffer sets from tick to
tick and makes the ``BatchedEnvState`` view only on demand.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Dict, List, Tuple

import torch

from ..envs import draws as D
from ..envs import trajectory as traj_lib
from ..envs.batch import (BatchedEnvState, BatchedStepOut,
                          batched_reset_plain, batched_step_plain)
from ..envs.dynamics import dop853_tableau
from ..utils.config import Config
from ..utils.tree import tree_from_named, tree_named_leaves
from .build import KernelSource, check

env_tick_plain = batched_step_plain

TASKS = {"decoupled": 0, "coupled": 1}
INTEGRATORS = {"euler": 0, "rk4": 1, "dop853": 2}
ENV_TYPES = {"train": 0, "eval": 1}
# Per task, the tick's output slots (name, per-env width) in the float and
# the bool output buffer: the agents' obs and terminal obs, one reward,
# done and crash flag per agent.
OUT = {
    "decoupled": {"F": (("obs1", 15), ("obs2", 3), ("reward", 2), ("ex", 3),
                        ("eb1", 1), ("term_obs1", 15), ("term_obs2", 3)),
                  "B": (("done", 2), ("reset", 1), ("crashed", 2))},
    "coupled": {"F": (("obs1", 23), ("reward", 1), ("ex", 3), ("eb1", 1),
                      ("term_obs1", 23)),
                "B": (("done", 1), ("reset", 1), ("crashed", 1))},
}
_KINDS = ((torch.float32, "F"), (torch.int32, "I"), (torch.bool, "B"))


@functools.lru_cache(maxsize=None)
def _template() -> BatchedEnvState:
    st, _ = batched_reset_plain(Config(num_envs=1),
                                torch.zeros(1, D.N_DRAWS), "train")
    return st


@functools.lru_cache(maxsize=None)
def layout() -> Dict[torch.dtype, List[Tuple[str, int, int, tuple]]]:
    """Per buffer dtype: ``[(path, offset, width, per-env shape)]``.
    A field of width ``w`` at offset ``off`` occupies
    ``buf[off*B : (off+w)*B]`` as a contiguous ``(B, w)`` block."""
    out = {dt: [] for dt, _ in _KINDS}
    for path, leaf in tree_named_leaves(_template()):
        shape = tuple(leaf.shape[1:])
        fields = out[leaf.dtype]
        off = fields[-1][1] + fields[-1][2] if fields else 0
        width = 1
        for s in shape:
            width *= s
        fields.append((path, off, width, shape))
    return out


def _width(fields) -> int:
    return fields[-1][1] + fields[-1][2] if fields else 0


def _macro(path: str) -> str:
    return path.replace(".", "_").upper()


def layout_header() -> Dict[str, str]:
    lines = ["// Generated by gym_rotor_tpu_torch/kernels/env_tick.py:",
             "// field offsets (in per-env scalars) of the state buffers.",
             "#pragma once"]
    lay = layout()
    for dt, kind in _KINDS:
        for path, off, width, _ in lay[dt]:
            lines.append(f"#define {kind}_{_macro(path)} {off}")
            lines.append(f"#define W{kind}_{_macro(path)} {width}")
        lines.append(f"#define N{kind}_STATE {_width(lay[dt])}")
    for task, out in OUT.items():
        t = task.upper()
        for kind, slots in out.items():
            off = 0
            for name, w in slots:
                lines.append(f"#define O{kind}_{t}_{name.upper()} {off}")
                lines.append(f"#define WO{kind}_{t}_{name.upper()} {w}")
                off += w
            lines.append(f"#define N{kind}_OUT_{t} {off}")
    lines += [f"#define D_THETA {D.THETA}", f"#define D_UDM {D.UDM.start}",
              f"#define D_AT_ORIGIN {D.AT_ORIGIN}",
              f"#define D_RESET {D.RESET.start}",
              f"#define D_FRESH_THETA {D.FRESH_THETA}",
              f"#define D_HOVER_T {D.HOVER_T}", f"#define D_HOVER_W {D.HOVER_W}",
              f"#define D_FRESH_HOVER_T {D.FRESH_HOVER_T}",
              f"#define D_FRESH_HOVER_W {D.FRESH_HOVER_W}",
              f"#define N_DRAWS {D.N_DRAWS}"]
    lines += [f"#define NEG_LOG_0001_D {traj_lib.NEG_LOG_0001.hex()}",
              f"#define EIGHT_EXP_XY_D {traj_lib.EIGHT_EXP_XY.hex()}"]
    lines += _dop853_macros()
    lines += [f"#define TASK_{k.upper()} {v}" for k, v in TASKS.items()]
    lines += [f"#define INTEGRATOR_{k.upper()} {v}"
              for k, v in INTEGRATORS.items()]
    lines += [f"#define ENV_{k.upper()} {v}" for k, v in ENV_TYPES.items()]
    return {"env_tick_layout.h": "\n".join(lines) + "\n"}


def _dop853_macros() -> List[str]:
    """DOP853's stages and final sum as macro lists over the nonzero
    coefficients of scipy's tableau (``dynamics.dop853_tableau``), each an
    exact hex literal: ``DOP853_STAGES(BEGIN, AXPY, EVAL)`` expands to
    ``BEGIN(i) AXPY(i, j, a_ij)... EVAL(i)`` for stages 0-11 and
    ``DOP853_SUM(SUM)`` to ``SUM(i, b_i)`` for each nonzero ``b_i``."""
    A, Bc, _ = dop853_tableau()
    stages = []
    for i in range(len(Bc)):
        axpys = "".join(f" AXPY({i}, {j}, {float(A[i, j]).hex()})"
                        for j in range(i) if A[i, j] != 0.0)
        stages.append(f"BEGIN({i}){axpys} EVAL({i})")
    total = " ".join(f"SUM({i}, {float(b).hex()})"
                     for i, b in enumerate(Bc) if b != 0.0)
    return ["#define DOP853_STAGES(BEGIN, AXPY, EVAL) \\\n  "
            + " \\\n  ".join(stages),
            f"#define DOP853_SUM(SUM) {total}"]


KERNEL = KernelSource("env_tick", ["-fmad=false"], layout_header)
WRAPPERS = {"env_tick": "env_tick_plain"}


def _lib():
    lib = KERNEL.load()
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.env_tick_launch.argtypes = [P, P, P, P, P, P, P, P, P, P,
                                        I, I, I, I, I, I, I, I, I, P, P]
        lib.env_tick_launch.restype = I
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# State <-> flat buffers
# ---------------------------------------------------------------------------
def unpack_state(bufs, B: int) -> BatchedEnvState:
    """Views of the three state buffers as a ``BatchedEnvState``."""
    leaves = {}
    lay = layout()
    for buf, (dt, _) in zip(bufs, _KINDS):
        for path, off, width, shape in lay[dt]:
            leaves[path] = buf[off * B:(off + width) * B].view((B,) + shape)
    return tree_from_named(_template(), leaves)


def pack_state(st: BatchedEnvState):
    """A packed copy of the state: its three flat buffers."""
    named = dict(tree_named_leaves(st))
    B = st.env.x.shape[0]
    lay = layout()
    bufs = []
    for dt, _ in _KINDS:
        parts = []
        for path, _, width, shape in lay[dt]:
            leaf = named[path]
            if leaf.dtype != dt or tuple(leaf.shape) != (B,) + shape:
                raise ValueError(f"state field {path}: expected {dt} "
                                 f"{(B,) + shape}, got {leaf.dtype} "
                                 f"{tuple(leaf.shape)}")
            parts.append(leaf.reshape(-1))
        bufs.append(torch.cat(parts))
    return tuple(bufs)


def out_width(task: str, kind: str) -> int:
    """Per-env scalars of ``task``'s float (``"F"``) or bool (``"B"``)
    output buffer."""
    return sum(w for _, w in OUT[task][kind])


def _out_views(task, outf, outb, B):
    views = {}
    for buf, kind in ((outf, "F"), (outb, "B")):
        off = 0
        for name, w in OUT[task][kind]:
            views[name] = buf[off * B:(off + w) * B].view(B, w)
            off += w
    return views


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
def task_of(cfg: Config) -> str:
    """The kernel's task for ``cfg``: ``"decoupled"`` (MODUL) or
    ``"coupled"`` (MONO), with any integrator of ``INTEGRATORS``, any
    trajectory mode and ``exact_so3`` on or off; raises for what no
    instance covers (the base ``quad`` task is not ported)."""
    task = {"MODUL": "decoupled", "MONO": "coupled"}.get(cfg.framework)
    if task is None or cfg.integrator not in INTEGRATORS:
        raise NotImplementedError(
            "env_tick kernel is built for MODUL/decoupled and MONO/coupled "
            f"with {', '.join(INTEGRATORS)} (the quad task is not ported); "
            f"got framework={cfg.framework!r} integrator={cfg.integrator!r}")
    return task


def instance(cfg: Config) -> str:
    """The name of the kernel instance ``cfg`` launches, e.g.
    ``decoupled_rk4`` or ``coupled_dop853_exact``."""
    return f"{task_of(cfg)}_{cfg.integrator}" + ("_exact" if cfg.exact_so3
                                                  else "")


@functools.lru_cache(maxsize=None)
def _coefs(cfg: Config):
    """Reward/integral constants rounded to float32 exactly where the JAX
    float32 tick rounds them: ``_interp01``'s ``rmin`` and slope ``1 / (0 -
    rmin)`` per agent reward of MODUL, then MONO's one reward."""
    u = cfg.UDM_percentage / 100.0
    r1, r2 = float(cfg.reward_min_1), float(cfg.reward_min_2)
    r = float(cfg.reward_min)
    vals = [cfg.Cx, cfg.CIx, cfg.Cv, cfg.Cw12, cfg.Cb1, cfg.CIb1, cfg.CW3,
            cfg.alpha, cfg.beta, u, u / 2.0,
            r1, (1.0 - 0.0) / (0.0 - r1), r2, (1.0 - 0.0) / (0.0 - r2),
            r, (1.0 - 0.0) / (0.0 - r)]
    return (ctypes.c_float * len(vals))(*vals)


def _check_cuda(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"env_tick: {name} must be a contiguous {dtype} "
                         f"{shape} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def empty_bufs(B: int, device):
    """A set of uninitialised state buffers for ``B`` envs."""
    lay = layout()
    return tuple(torch.empty(_width(lay[dt]) * B, dtype=dt, device=device)
                 for dt, _ in _KINDS)


def _launch(cfg, in_bufs, actions, draws, env_type, B, device, out_bufs):
    if env_type not in ENV_TYPES:
        raise ValueError(f"unknown env_type {env_type!r}")
    if B == 0:
        raise ValueError("env_tick: no envs (B = 0)")
    task = task_of(cfg)
    outf = torch.empty(out_width(task, "F") * B, dtype=torch.float32,
                       device=device)
    outb = torch.empty(out_width(task, "B") * B, dtype=torch.bool,
                       device=device)
    lib = _lib()

    def ptr(t):
        return None if t is None else t.data_ptr()
    ins = in_bufs if in_bufs is not None else (None, None, None)
    err = lib.env_tick_launch(
        *(ptr(t) for t in ins), *(ptr(t) for t in out_bufs),
        ptr(actions), ptr(draws), ptr(outf), ptr(outb),
        B, int(in_bufs is None), TASKS[task],
        INTEGRATORS[cfg.integrator], int(cfg.exact_so3),
        int(cfg.train_traj_mode), ENV_TYPES[env_type], cfg.max_steps,
        int(cfg.use_UDM), _coefs(cfg),
        torch.cuda.current_stream(device).cuda_stream)
    check(err, lib, "env_tick")
    env_tick.launches += 1
    env_tick.by_instance[instance(cfg)] += 1
    return _out_views(task, outf, outb, B)


def _obs(o, n_agents, prefix="obs"):
    return tuple(o[f"{prefix}{a + 1}"] for a in range(n_agents))


def env_tick_bufs(cfg: Config, in_bufs, actions: torch.Tensor,
                  draws: torch.Tensor, env_type: str, out_bufs):
    """One K1 launch on packed state: reads ``in_bufs``, writes the next
    state into ``out_bufs`` (both from ``pack_state``/``empty_bufs``, for
    ``B = actions.shape[0]`` envs on the card) and returns the tick's
    ``BatchedStepOut``.  ``actions`` is ``(B, sum(cfg.action_dim_n))``."""
    task_of(cfg)
    B, device = actions.shape[0], actions.device
    lay = layout()
    for name, bufs in (("state", in_bufs), ("next state", out_bufs)):
        for (dt, _), buf in zip(_KINDS, bufs):
            _check_cuda(f"{name} buffer", buf, dt, (_width(lay[dt]) * B,),
                        device)
    _check_cuda("actions", actions, torch.float32,
                (B, sum(cfg.action_dim_n)), device)
    _check_cuda("draws", draws, torch.float32, (B, D.N_DRAWS), device)
    o = _launch(cfg, in_bufs, actions, draws, env_type, B, device, out_bufs)
    n = cfg.n_agents
    return BatchedStepOut(
        obs=_obs(o, n), reward=o["reward"], done=o["done"],
        reset_happened=o["reset"][:, 0],
        info={"ex": o["ex"], "eb1": o["eb1"][:, 0],
              "terminal_obs": _obs(o, n, "term_obs"),
              "crashed": o["crashed"]})


def env_tick(cfg: Config, bstate: BatchedEnvState, actions: torch.Tensor,
             draws: torch.Tensor, env_type: str = "train"):
    """One K1 tick.  CPU tensors -> ``env_tick_plain``; CUDA tensors -> one
    kernel launch (float32 only) on a packed copy of the state, or an
    error.  The returned state is a view of fresh buffers."""
    if not actions.is_cuda:
        return env_tick_plain(cfg, bstate, actions, draws, env_type)
    B = actions.shape[0]
    out_bufs = empty_bufs(B, actions.device)
    out = env_tick_bufs(cfg, pack_state(bstate), actions, draws, env_type,
                        out_bufs)
    return unpack_state(out_bufs, B), out


env_tick.launches = 0
# launches per kernel instance (``instance``), beside the total
env_tick.by_instance = Counter()


def env_reset(cfg: Config, draws: torch.Tensor, env_type: str = "train"):
    """Fresh episodes for every row of ``draws`` (``batched_reset``): the
    kernel's reset entry on CUDA, ``batched_reset_plain`` on the CPU.
    Counted under ``env_tick.launches``: it is the same kernel."""
    if not draws.is_cuda:
        return batched_reset_plain(cfg, draws, env_type)
    B = draws.shape[0]
    _check_cuda("draws", draws, torch.float32, (B, D.N_DRAWS), draws.device)
    out_bufs = empty_bufs(B, draws.device)
    o = _launch(cfg, None, None, draws, env_type, B, draws.device, out_bufs)
    return unpack_state(out_bufs, B), _obs(o, cfg.n_agents)


class TickLoop:
    """Steps one batched state tick after tick.  On the card the state
    stays packed: each launch reads one of two buffer sets and writes the
    other, and the ``BatchedEnvState`` view is made only when ``state`` is
    read.  On the CPU each step is ``env_tick_plain``."""

    def __init__(self, cfg: Config, bstate: BatchedEnvState,
                 env_type: str = "train"):
        self.cfg, self.env_type = cfg, env_type
        self.B = bstate.env.x.shape[0]
        self.dtype, self.device = bstate.env.x.dtype, bstate.env.x.device
        if self.device.type == "cuda":
            self._bufs = pack_state(bstate)
            self._spare = empty_bufs(self.B, self.device)
        else:
            self._bufs, self._state = None, bstate

    def step(self, actions: torch.Tensor, draws: torch.Tensor):
        """One tick; returns its ``BatchedStepOut``."""
        if self._bufs is None:
            self._state, out = env_tick_plain(self.cfg, self._state, actions,
                                              draws, self.env_type)
            return out
        out = env_tick_bufs(self.cfg, self._bufs, actions, draws,
                            self.env_type, self._spare)
        self._bufs, self._spare = self._spare, self._bufs
        return out

    @property
    def state(self) -> BatchedEnvState:
        """The current state; on the card a view of the live buffers, valid
        until the next ``step``."""
        if self._bufs is None:
            return self._state
        return unpack_state(self._bufs, self.B)
