"""The reference's fixed-seed evaluation episodes, replayed (port of
``gym_rotor_tpu/envs/ref_stream.py``).

The reference evaluates 10 sequential episodes on one env after
``np.random.seed(1992)``; each episode consumes exactly 13 uniforms of that
stream (yaw, x, v, W, roll/pitch, then the first mode-0 heading offset), so
the 10 initial conditions are replayed on the host without simulating
(``reference_eval_inits``) and lifted into one batched state on the device
(``batched_reset_reference``), one env per episode.  Mode-0 eval protocol
only: the tracking modes draw more.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import so3
from ..utils.config import Config
from ..utils.device import resolve_device
from . import draws as D
from . import params as params_lib
from . import quad
from .batch import BatchedEnvState
from .oracle import euler_to_rot, psvd
from .trajectory import TrajState, get_desired, mark_traj_start

D2R = np.pi / 180.0


def reference_eval_inits(num_eval: int, seed: int = 1992):
    """``num_eval`` reference eval-episode resets from ``seed``
    (``ref_stream.py:50-94``): float64 ``x/v/W (N, 3)``, ``R (N, 3, 3)``,
    ``b1d (N, 3)``, bit for bit what the reference produces."""
    # np.random.seed(s) + np.random.uniform is the legacy MT19937 stream; a
    # private RandomState(seed) gives the same stream without touching the
    # global one
    rs = np.random.RandomState(seed)
    xs, vs, Ws, Rs, b1ds = [], [], [], [], []
    for _ in range(num_eval):
        yaw = rs.uniform(size=1, low=-np.pi, high=np.pi)
        x = rs.uniform(size=3, low=-0.4, high=0.4)
        v = rs.uniform(size=3, low=-0.0, high=0.0)
        W = rs.uniform(size=3, low=-0.0, high=0.0)
        roll_pitch = rs.uniform(size=2, low=-0.0, high=0.0)
        euler = np.concatenate((roll_pitch, yaw), axis=None)
        # the reference builds R through scipy's quaternions, whose rounding
        # differs from Rz Ry Rx in the last ulp
        try:
            from scipy.spatial.transform import Rotation
            R = Rotation.from_euler("xyz", euler, degrees=False).as_matrix()
        except ImportError:
            R = euler_to_rot(euler)
        # the rotation check and the psvd repair
        if not np.linalg.norm(np.eye(3) - R.T @ R) < 1e-6:
            U, _, V = psvd(R)
            R = U @ V.T
        # the first mode-0 get_desired: b1d = R_e3(theta) @ heading of R
        theta_b1d = rs.uniform(size=1, low=-25 * D2R, high=25 * D2R)
        b1 = R.dot(np.array([1.0, 0.0, 0.0]))
        theta = np.arctan2(b1[1], b1[0])
        b1d_temp = np.array([np.cos(theta), np.sin(theta), 0.0])
        c, s = np.cos(theta_b1d[0]), np.sin(theta_b1d[0])
        R_e3 = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        b1d = R_e3 @ b1d_temp
        xs.append(x); vs.append(v); Ws.append(W); Rs.append(R)
        b1ds.append(b1d)
    return {"x": np.stack(xs), "v": np.stack(vs), "W": np.stack(Ws),
            "R": np.stack(Rs), "b1d": np.stack(b1ds)}


def batched_reset_reference(cfg: Config, seed: Optional[int] = None,
                            dtype=torch.float32, device=None):
    """The eval reset from the reference's episode stream
    (``ref_stream.py:97-146``): env i of ``cfg.num_envs`` replays episode
    i, with nominal params, zero integrals and the mode-0 zero setpoint at
    the stream's heading.  The reference driver's order reset ->
    mark_traj_start -> get_desired -> set_goal_state ->
    get_norm_error_state, in plain torch on ``device`` (default: the card):
    the poses are given, so K1's reset entry, which draws them, cannot
    lift them.  Returns ``(state, obs)``."""
    if cfg.train_traj_mode != 0:
        raise ValueError(
            "eval_stream='reference' replays the mode-0 eval protocol; "
            f"train_traj_mode={cfg.train_traj_mode} draws extra per-mode "
            "randoms the replay does not model; use eval_stream='parallel'.")
    dev = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    n = cfg.num_envs
    inits = reference_eval_inits(n, seed)
    x, v, R, W, b1d = (torch.as_tensor(inits[k], dtype=dtype).to(dev)
                       for k in ("x", "v", "R", "W", "b1d"))
    if cfg.exact_so3:
        R = so3.ensure_so3_exact(R)
    state = quad.fresh_state(params_lib.nominal((n,), dtype, dev), x, v, R, W)
    ts = mark_traj_start(TrajState.create((n,), dtype, dev), state.x, state.R)
    # the mode-0 heading draw happened on the host: freeze it (init_b1d
    # False) and pin the zero setpoint
    z3 = torch.zeros_like(x)
    ts = dataclasses.replace(ts, init_b1d=torch.zeros_like(ts.init_b1d),
                             b1d=b1d, xd=z3, vd=z3.clone(), Wd=z3.clone())
    # mode 0 with init_b1d False reads no draw
    zero = torch.zeros(n, dtype=dtype, device=dev)
    ts, goal = get_desired(ts, state.x, state.v, state.R, state.W, 0,
                           D.TrajDraws(zero, zero, zero))
    state, obs = quad.initial_obs(cfg, dataclasses.replace(state, goal=goal))
    return BatchedEnvState(env=state, traj=ts), obs
