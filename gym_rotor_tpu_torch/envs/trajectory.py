"""Reference-signal generator (port of ``gym_rotor_tpu/envs/trajectory.py``):
the per-env goal state machine of every mode.

Modes: 0 idle (random heading offset), 1 hover, 2 take-off, 3 landing,
4 stay, 5 circle, 6 and above figure-eight; a machine that completes its
trajectory (modes 2, 4, 5, 6) holds in manual mode.  ``TrajState`` keeps
every field of the JAX machine minus its PRNG key: the random draws come
in as ``draws.TrajDraws`` and every slot is consumed every tick, as the
JAX machine splits its key every tick.

``get_desired`` with a Python int ``mode`` is the training path's static
branch (``batched_step`` passes ``cfg.train_traj_mode``); with a tensor it
is the runtime-mode path (a mode change restarts the machine, every branch
is computed and selected per env).  Constants that JAX folds in Python
float64 are folded the same way here, each rounded once to the dtype.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

import torch

from ..ops import so3
from ..utils.tree import select
from .draws import TrajDraws, uniform_in
from .dynamics import dot3, mm3, mv3
from .quad import DT
from .state import Goal

IDLE_YAW = 25.0 * math.pi / 180.0     # mode-0 heading offset range
# mode constants (trajectory.py:30-50)
TAKEOFF_END_HEIGHT = -0.5
TAKEOFF_VELOCITY = -0.05
LANDING_VELOCITY = 1.0
LANDING_CUTOFF_HEIGHT = -0.25
NUM_CIRCLES = 2
CIRCLE_RADIUS = 0.7
CIRCLE_LINEAR_V = 0.4
CIRCLE_W = 0.4
NUM_EIGHTS = 3
EIGHT_A1 = 1.5
EIGHT_A2 = 1.0
EIGHT_T = 9.0
EIGHT_W1 = 2.0 * math.pi / EIGHT_T
EIGHT_W2 = 4.0 * math.pi / EIGHT_T
EIGHT_W_B1D = 0.349066          # 20 deg/s
EIGHT_EPS = 0.01
EIGHT_EXP_XY = -math.log(EIGHT_EPS) / EIGHT_T
EIGHT_ALT_D = -0.6
HOVER_T = (2.0, 5.0)                       # settle time range [s]
HOVER_W = (-0.15 * math.pi, 0.15 * math.pi)  # yaw rate range [rad/s]
# -jnp.log(0.001) (trajectory.py:168): float64 under x64, float32 without;
# log(0.001) folded in float64 and rounded once gives both (the float32
# rounding of the float64 value equals logf(0.001f))
NEG_LOG_0001 = -math.log(0.001)
N_MODES = 7


@dataclass
class TrajState:
    mode: torch.Tensor          # int32
    t: torch.Tensor
    t_traj: torch.Tensor
    started: torch.Tensor       # bool
    complete: torch.Tensor      # bool
    manual_mode: torch.Tensor   # bool
    manual_init: torch.Tensor   # bool
    is_landed: torch.Tensor     # bool
    init_b1d: torch.Tensor      # bool
    x_init: torch.Tensor
    theta_init: torch.Tensor
    x_goal: torch.Tensor
    smooth_term: torch.Tensor
    w_b1d: torch.Tensor
    center: torch.Tensor
    xd: torch.Tensor
    vd: torch.Tensor
    b1d: torch.Tensor
    b1d_dot: torch.Tensor
    Wd: torch.Tensor

    @classmethod
    def create(cls, batch=(), dtype=torch.float32, device=None):
        batch = tuple(batch)

        def z(*tail):
            return torch.zeros(batch + tail, dtype=dtype, device=device)

        def flag(v):
            return torch.full(batch, v, dtype=torch.bool, device=device)

        b1d = z(3)
        b1d[..., 0] = 1.0
        return cls(
            mode=torch.zeros(batch, dtype=torch.int32, device=device),
            t=z(), t_traj=z(), started=flag(False), complete=flag(False),
            manual_mode=flag(False), manual_init=flag(False),
            is_landed=flag(False), init_b1d=flag(True),
            x_init=z(3), theta_init=z(), x_goal=z(3), smooth_term=z(),
            w_b1d=z(), center=z(3), xd=z(3), vd=z(3), b1d=b1d, b1d_dot=z(3),
            Wd=z(3))


def mark_traj_start(ts: TrajState, x, R) -> TrajState:
    """Reset the machine at an episode start (trajectory.py:97-108)."""
    b1 = R[..., :, 0]
    theta_init = torch.atan2(b1[..., 1], b1[..., 0])
    z = torch.zeros_like(ts.t)
    false = torch.zeros_like(ts.started)
    return dataclasses.replace(
        ts, started=false, complete=false.clone(), manual_mode=false.clone(),
        manual_init=false.clone(), is_landed=false.clone(),
        init_b1d=torch.ones_like(ts.init_b1d), t=z, t_traj=z.clone(),
        x_init=x, theta_init=theta_init)


def _heading_of(R):
    b1 = R[..., :, 0]
    theta = torch.atan2(b1[..., 1], b1[..., 0])
    return torch.stack([torch.cos(theta), torch.sin(theta),
                        torch.zeros_like(theta)], dim=-1)


def _set_to_current(ts: TrajState, x, v, R) -> TrajState:
    """set_desired_states_to_current (trajectory.py:118-120)."""
    return dataclasses.replace(ts, xd=x, vd=v, b1d=_heading_of(R))


def _set_to_zero(ts: TrajState) -> TrajState:
    z3 = torch.zeros_like(ts.xd)
    b1d = torch.zeros_like(ts.b1d)
    b1d[..., 0] = 1.0
    return dataclasses.replace(ts, xd=z3, vd=z3, Wd=torch.zeros_like(ts.Wd),
                               b1d=b1d)


def _const(ref, c):
    """The Python float ``c`` rounded once to ``ref``'s dtype."""
    return torch.tensor(c, dtype=ref.dtype, device=ref.device)


def _where(c, a, b):
    """``jnp.where`` with ``c`` broadcast over the trailing dims of ``a``."""
    return torch.where(c.reshape(c.shape + (1,) * (a.dim() - c.dim())), a, b)


def _set(v, k, val):
    """``v.at[..., k].set(val)`` on a copy."""
    out = v.clone()
    out[..., k] = val
    return out


def _stack3(a, b, c):
    return torch.stack([a, b, c], dim=-1)


# ---------------------------------------------------------------------------
# Mode branches: each takes (ts, x, v, R, u) and returns the updated machine
# with t advanced where the mode advances it (trajectory.py:134-376).
# ---------------------------------------------------------------------------
def _mode_idle(ts: TrajState, x, v, R, u: TrajDraws) -> TrajState:
    """Mode 0 (trajectory.py:134-153): zero goal, heading = current heading
    turned by a random yaw in +-25 deg, taken once per machine start."""
    theta = uniform_in(u.theta, -IDLE_YAW, IDLE_YAW)
    b1d_cur = _heading_of(R)
    b1d_new = mv3(so3.rot_z(theta), b1d_cur)
    zeroed = _set_to_zero(ts)
    take = ts.init_b1d[..., None]
    return dataclasses.replace(
        ts,
        xd=torch.where(take, zeroed.xd, ts.xd),
        vd=torch.where(take, zeroed.vd, ts.vd),
        Wd=torch.where(take, zeroed.Wd, ts.Wd),
        b1d=torch.where(take, b1d_new, ts.b1d),
        init_b1d=torch.where(ts.init_b1d, False, ts.init_b1d))


def _mode_hover(ts: TrajState, x, v, R, u: TrajDraws) -> TrajState:
    """Mode 1 (trajectory.py:156-184): exponential settle to the origin
    with settle time U(2, 5) s and yaw rate U(+-0.15 pi), drawn at start."""
    t_traj_new = uniform_in(u.hover_t, *HOVER_T)
    w_new = uniform_in(u.hover_w, *HOVER_W)
    st = ts.started
    x_init = _where(st, ts.x_init, x)
    x_goal = torch.zeros_like(x)
    t_traj = torch.where(st, ts.t_traj, t_traj_new)
    smooth = torch.where(st, ts.smooth_term,
                         _const(ts.t, NEG_LOG_0001) / t_traj_new)
    w_b1d = torch.where(st, ts.w_b1d, w_new)
    t = ts.t + DT
    e = torch.exp(-smooth * t)
    xd = (x_init - x_goal) * e[..., None] + x_goal
    vd = -(x_init - x_goal) * (smooth * e)[..., None]
    phase = w_b1d * t + ts.theta_init
    z = torch.zeros_like(phase)
    b1d = _stack3(torch.cos(phase), torch.sin(phase), z)
    b1d_dot = _stack3(-w_b1d * torch.sin(phase), w_b1d * torch.cos(phase), z)
    return dataclasses.replace(
        ts, started=torch.ones_like(st), x_init=x_init, x_goal=x_goal,
        t_traj=t_traj, smooth_term=smooth, w_b1d=w_b1d, t=t, xd=xd, vd=vd,
        b1d=b1d, b1d_dot=b1d_dot)


def _mode_takeoff(ts: TrajState, x, v, R, u: TrajDraws) -> TrajState:
    """Mode 2 (trajectory.py:187-215): constant-velocity climb to
    TAKEOFF_END_HEIGHT, then hold and switch to manual."""
    st = ts.started
    zeroed = _set_to_zero(ts)
    xd0 = _set(_set(zeroed.xd, 0, x[..., 0]), 1, x[..., 1])
    x_init = _where(st, ts.x_init, x)
    t_traj = torch.where(st, ts.t_traj,
                         (TAKEOFF_END_HEIGHT - x[..., 2]) / TAKEOFF_VELOCITY)
    b1d = _where(st, ts.b1d, _heading_of(R))
    xd = _where(st, ts.xd, xd0)
    vd = _where(st, ts.vd, zeroed.vd)
    t = ts.t + DT
    climbing = t < t_traj
    xd2 = torch.where(climbing, x_init[..., 2] + TAKEOFF_VELOCITY * t,
                      ts.xd[..., 2])
    delta = xd - x
    # jnp.sum over the 3 components: (d0^2 + d1^2) + d2^2
    reached = so3.sqrt_rn(dot3(delta, delta)) < 0.04
    hold = (~climbing) & reached
    xd2 = torch.where(hold, _const(xd2, TAKEOFF_END_HEIGHT), xd2)
    vd2 = torch.where(hold, _const(xd2, 0.0), vd[..., 2])
    return dataclasses.replace(
        ts, started=torch.ones_like(st), x_init=x_init, t_traj=t_traj, t=t,
        xd=_set(xd, 2, xd2), vd=_set(vd, 2, vd2), b1d=b1d,
        complete=ts.complete | hold, manual_mode=ts.manual_mode | hold)


def _mode_land(ts: TrajState, x, v, R, u: TrajDraws) -> TrajState:
    """Mode 3 (trajectory.py:218-242): constant-velocity descent to the
    motor-cutoff height."""
    st = ts.started
    cur = _set_to_current(ts, x, v, R)
    xd = _where(st, ts.xd, cur.xd)
    vd = _where(st, ts.vd, cur.vd)
    b1d = _where(st, ts.b1d, cur.b1d)
    x_init = _where(st, ts.x_init, x)
    t_traj = torch.where(
        st, ts.t_traj, (LANDING_CUTOFF_HEIGHT - x[..., 2]) / LANDING_VELOCITY)
    t = ts.t + DT
    descending = t < t_traj
    xd2 = torch.where(descending, x_init[..., 2] + LANDING_VELOCITY * t,
                      _const(t, LANDING_CUTOFF_HEIGHT))
    above = x[..., 2] > LANDING_CUTOFF_HEIGHT
    vd2 = torch.where(descending, vd[..., 2],
                      torch.where(above, _const(t, 0.0),
                                  _const(t, LANDING_VELOCITY)))
    landed = (~descending) & above
    return dataclasses.replace(
        ts, started=torch.ones_like(st), x_init=x_init, t_traj=t_traj, t=t,
        xd=_set(xd, 2, xd2), vd=_set(vd, 2, vd2), b1d=b1d,
        complete=ts.complete | landed, is_landed=ts.is_landed | landed)


def _mode_stay(ts: TrajState, x, v, R, u: TrajDraws) -> TrajState:
    """Mode 4 (trajectory.py:245-256): hold the current pose; complete and
    in manual mode at once (t does not advance)."""
    st = ts.started
    cur = _set_to_current(ts, x, v, R)
    return dataclasses.replace(
        ts, started=torch.ones_like(st),
        xd=_where(st, ts.xd, cur.xd), vd=_where(st, ts.vd, cur.vd),
        b1d=_where(st, ts.b1d, cur.b1d),
        complete=torch.ones_like(ts.complete),
        manual_mode=torch.ones_like(ts.manual_mode))


def _mode_circle(ts: TrajState, x, v, R, u: TrajDraws) -> TrajState:
    """Mode 5 (trajectory.py:259-307): a straight lead-in along +x, then
    NUM_CIRCLES revolutions with the heading turning along."""
    st = ts.started
    cur = _set_to_current(ts, x, v, R)
    center = _where(st, ts.center, x)
    t_traj_new = CIRCLE_RADIUS / CIRCLE_LINEAR_V \
        + NUM_CIRCLES * 2.0 * math.pi / CIRCLE_W
    t_traj = torch.where(st, ts.t_traj, _const(ts.t, t_traj_new))
    xd = _where(st, ts.xd, cur.xd)
    vd = _where(st, ts.vd, cur.vd)
    b1d = _where(st, ts.b1d, cur.b1d)
    t = ts.t + DT

    lead_t = CIRCLE_RADIUS / CIRCLE_LINEAR_V
    in_lead = t < lead_t
    in_circle = (~in_lead) & (t < t_traj)
    xd0_lead = center[..., 0] + CIRCLE_LINEAR_V * t
    vd0_lead = torch.full_like(t, CIRCLE_LINEAR_V)
    tc = t - lead_t
    th = CIRCLE_W * tc
    xd0_circ = CIRCLE_RADIUS * torch.cos(th) + center[..., 0]
    vd0_circ = -CIRCLE_RADIUS * CIRCLE_W * torch.sin(th)
    xd1_circ = CIRCLE_RADIUS * torch.sin(th) + center[..., 1]
    vd1_circ = CIRCLE_RADIUS * CIRCLE_W * torch.cos(th)
    th_b1d = CIRCLE_W * tc + math.pi
    z = torch.zeros_like(th_b1d)
    b1d_circ = _stack3(torch.cos(th_b1d), torch.sin(th_b1d), z)
    b1d_dot_circ = _stack3(-CIRCLE_W * torch.sin(th_b1d),
                           CIRCLE_W * torch.cos(th_b1d), z)

    xd0 = torch.where(in_lead, xd0_lead,
                      torch.where(in_circle, xd0_circ, xd[..., 0]))
    vd0 = torch.where(in_lead, vd0_lead,
                      torch.where(in_circle, vd0_circ, vd[..., 0]))
    xd1 = torch.where(in_circle, xd1_circ, xd[..., 1])
    vd1 = torch.where(in_circle, vd1_circ, vd[..., 1])
    ended = (~in_lead) & (~in_circle)
    return dataclasses.replace(
        ts, started=torch.ones_like(st), center=center, t_traj=t_traj, t=t,
        xd=_set(_set(xd, 0, xd0), 1, xd1), vd=_set(_set(vd, 0, vd0), 1, vd1),
        b1d=_where(in_circle, b1d_circ, b1d),
        b1d_dot=_where(in_circle, b1d_dot_circ, ts.b1d_dot),
        complete=ts.complete | ended, manual_mode=ts.manual_mode | ended)


def _mode_eight(ts: TrajState, x, v, R, u: TrajDraws) -> TrajState:
    """Mode 6 and above (trajectory.py:310-357): an exponentially smoothed
    Lissajous figure-eight with a synchronised altitude and a turning
    heading."""
    st = ts.started
    cur = _set_to_current(ts, x, v, R)
    center = _where(st, ts.center, x)
    t_traj = torch.where(st, ts.t_traj, _const(ts.t, NUM_EIGHTS * EIGHT_T))
    w_b1d = torch.where(st, ts.w_b1d, _const(ts.t, EIGHT_W_B1D))
    xd = _where(st, ts.xd, cur.xd)
    vd = _where(st, ts.vd, cur.vd)
    b1d = _where(st, ts.b1d, cur.b1d)
    t = ts.t + DT
    active = t < t_traj

    exp_term = 1.0 - torch.exp(-EIGHT_EXP_XY * t)
    d_exp = EIGHT_EXP_XY * torch.exp(-EIGHT_EXP_XY * t)
    xd0 = EIGHT_A2 * (torch.sin(EIGHT_W2 * t) * exp_term) + center[..., 0]
    vd0 = EIGHT_A2 * ((EIGHT_W2 * torch.cos(EIGHT_W2 * t)) * exp_term
                      + torch.sin(EIGHT_W2 * t) * d_exp)
    xd1 = EIGHT_A1 * (torch.cos(EIGHT_W1 * t) - 1.0) * exp_term \
        + center[..., 1]
    vd1 = EIGHT_A1 * ((EIGHT_W1 * -torch.sin(EIGHT_W1 * t)) * exp_term
                      + (torch.cos(EIGHT_W1 * t) - 1.0) * d_exp)
    z_amp = (center[..., 2] - EIGHT_ALT_D) / 2.0
    xd2 = z_amp * (1.0 - torch.cos(EIGHT_W1 * t)) + center[..., 2]
    vd2 = z_amp * EIGHT_W1 * torch.sin(EIGHT_W1 * t)
    phase = w_b1d * t * exp_term + ts.theta_init
    d_phase = w_b1d * (exp_term + t * d_exp)
    z = torch.zeros_like(phase)
    b1d_e = _stack3(torch.cos(phase), torch.sin(phase), z)
    b1d_dot_e = _stack3(-torch.sin(phase) * d_phase,
                        torch.cos(phase) * d_phase, z)
    return dataclasses.replace(
        ts, started=torch.ones_like(st), center=center, t_traj=t_traj,
        w_b1d=w_b1d, t=t,
        xd=_where(active, _stack3(xd0, xd1, xd2), xd),
        vd=_where(active, _stack3(vd0, vd1, vd2), vd),
        b1d=_where(active, b1d_e, b1d),
        b1d_dot=_where(active, b1d_dot_e, ts.b1d_dot),
        complete=ts.complete | ~active, manual_mode=ts.manual_mode | ~active)


def _mode_manual(ts: TrajState, x, v, R) -> TrajState:
    """Manual-mode hold (trajectory.py:360-376): zero velocity, heading
    frozen at its angle when the hold began; t does not advance."""
    init = ts.manual_init
    b1 = R[..., :, 0]
    theta0 = torch.atan2(b1[..., 1], b1[..., 0])
    theta_init = torch.where(init, ts.theta_init, theta0)
    xd = _where(init, ts.xd, x)
    b1d = _stack3(torch.cos(theta_init), torch.sin(theta_init),
                  torch.zeros_like(theta_init))
    return dataclasses.replace(
        ts, manual_init=torch.ones_like(init), theta_init=theta_init, xd=xd,
        vd=torch.zeros_like(ts.vd), b1d=b1d)


_MODES = (_mode_idle, _mode_hover, _mode_takeoff, _mode_land, _mode_stay,
          _mode_circle, _mode_eight)


def get_desired(ts: TrajState, x, v, R, W, mode,
                u: TrajDraws) -> Tuple[TrajState, Goal]:
    """``get_desired`` (trajectory.py:382-431): run the mode's branch (or
    the manual hold), then Wd from the heading kinematics.

    ``mode`` a Python int: the static branch, ``min(max(mode, 0), 6)`` (so
    mode 7 is the eight), the raw mode stored; for mode >= 2 the manual
    hold replaces the branch in the envs already in manual mode at entry,
    and their Wd stays frozen.  ``mode`` a tensor (per env, or 0-d): the
    runtime path; where it differs from the stored mode the machine
    restarts (``mark_traj_start``), every branch is computed and the
    clamped mode's selected, and the manual overlay applies to every mode."""
    if isinstance(mode, int):
        branch = min(max(mode, 0), N_MODES - 1)
        ts = dataclasses.replace(ts, mode=torch.full_like(ts.mode, mode))
        if mode >= 2:
            use_man = ts.manual_mode
            ts = select(use_man, _mode_manual(ts, x, v, R),
                        _MODES[branch](ts, x, v, R, u))
            return _with_wd(ts, R, W, freeze=use_man)
        return _with_wd(_MODES[branch](ts, x, v, R, u), R, W)

    mode = torch.as_tensor(mode, dtype=torch.int32,
                           device=ts.mode.device).expand_as(ts.mode)
    changed = mode != ts.mode
    ts = select(changed, mark_traj_start(ts, x, R), ts)
    ts = dataclasses.replace(ts, mode=mode.clone())
    branch = torch.clamp(mode, 0, N_MODES - 1)
    auto = ts
    for k, fn in enumerate(_MODES):
        auto = select(branch == k, fn(ts, x, v, R, u), auto)
    use_man = ts.manual_mode
    ts = select(use_man, _mode_manual(ts, x, v, R), auto)
    return _with_wd(ts, R, W, freeze=use_man)


def _with_wd(ts: TrajState, R, W, freeze=None) -> Tuple[TrajState, Goal]:
    """Wd from the b1c kinematics (trajectory.py:434-456); with ``freeze``
    (the envs in manual mode at entry) Wd keeps its last value, as the
    reference's early return leaves it."""
    b3 = R[..., :, 2]
    b3_dot = mm3(R, so3.hat(W))[..., :, 2]
    b1d, b1d_dot = ts.b1d, ts.b1d_dot
    b1c = b1d - dot3(b1d, b3)[..., None] * b3
    b1c_dot = b1d_dot - (
        dot3(b1d_dot, b3)[..., None] * b3
        + dot3(b1d, b3_dot)[..., None] * b3
        + dot3(b1d, b3)[..., None] * b3_dot)
    omega_c = so3.cross(b1c, b1c_dot)
    omega_c3 = dot3(b3, omega_c)
    Wd = torch.zeros_like(ts.Wd)
    Wd[..., 2] = omega_c3
    if freeze is not None:
        Wd = _where(freeze, ts.Wd, Wd)
    ts = dataclasses.replace(ts, Wd=Wd)
    goal = Goal(xd=ts.xd, vd=ts.vd, b1d=ts.b1d, b1d_dot=ts.b1d_dot, Wd=Wd)
    return ts, goal
