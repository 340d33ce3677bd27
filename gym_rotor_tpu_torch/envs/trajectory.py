"""Reference-signal generator, mode 0 (port of
``gym_rotor_tpu/envs/trajectory.py``).

``TrajState`` keeps every field of the JAX machine (minus the PRNG key) so
later modes fit without a layout change.  Only the static-int fast path of
``get_desired`` for mode 0 (the flagship's ``train_traj_mode``) is ported;
modes 1-6 and the runtime-mode path raise.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

import torch

from ..ops import so3
from .draws import uniform_in
from .dynamics import dot3, mm3, mv3
from .state import Goal

IDLE_YAW = 25.0 * math.pi / 180.0     # mode-0 heading offset range


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


def _set_to_zero(ts: TrajState) -> TrajState:
    z3 = torch.zeros_like(ts.xd)
    b1d = torch.zeros_like(ts.b1d)
    b1d[..., 0] = 1.0
    return dataclasses.replace(ts, xd=z3, vd=z3, Wd=torch.zeros_like(ts.Wd),
                               b1d=b1d)


def _mode_idle(ts: TrajState, x, v, R, u_theta) -> TrajState:
    """Mode 0 (trajectory.py:134-153): zero goal, heading = current heading
    turned by a random yaw in +-25 deg, taken once per machine start.  The
    draw ``u_theta`` is consumed every tick, as the JAX key split is."""
    theta = uniform_in(u_theta, -IDLE_YAW, IDLE_YAW)
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


def get_desired(ts: TrajState, x, v, R, W, mode: int,
                u_theta) -> Tuple[TrajState, Goal]:
    """Static-int branch of ``get_desired`` (trajectory.py:392-408)."""
    if not isinstance(mode, int) or mode != 0:
        raise NotImplementedError(
            f"trajectory mode {mode!r} is not ported yet (mode 0 is)")
    ts = dataclasses.replace(ts, mode=torch.full_like(ts.mode, mode))
    ts = _mode_idle(ts, x, v, R, u_theta)
    return _with_wd(ts, R, W)


def _with_wd(ts: TrajState, R, W) -> Tuple[TrajState, Goal]:
    """Wd from the b1c kinematics (trajectory.py:434-456, no freeze: modes
    0 and 1 never enter manual hold)."""
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
    ts = dataclasses.replace(ts, Wd=Wd)
    goal = Goal(xd=ts.xd, vd=ts.vd, b1d=ts.b1d, b1d_dot=ts.b1d_dot, Wd=Wd)
    return ts, goal
