"""Functional quadrotor environment core, all three tasks of the JAX
package (port of ``gym_rotor_tpu/envs/quad.py``): the base ``quad`` env
(per-motor thrusts, the 18-float state as obs, reward and done on the raw
errors; only the Gym API selects it), MONO's ``coupled`` and MODUL's
``decoupled``.

``step``'s task follows ``cfg.framework`` unless the caller names one.
Under ``cfg.exact_so3`` the stored attitude drifts as the integrator
leaves it and every read of R repairs it on the fly (``_ensure_R``), as
the reference does; otherwise one polar step a tick keeps the stored R
orthonormal.  The wrappers' observations are cast to float32 exactly as
the JAX package does, and their rewards/dones are computed from that
float32 obs, also on the float64 parity path.  Observations are always a
tuple, one array per agent: ``(obs1, obs2)`` for MODUL, ``(obs,)`` for
MONO and for ``quad`` (the JAX ``batch._obs_tuple``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from ..ops import so3
from ..utils.config import Config
from . import draws as D
from . import params as params_lib
from .draws import uniform_in
from .dynamics import dot3, integrate
from .params import QuadParams
from .state import EnvState, Goal, pack_state

X_LIM = 1.0
V_LIM = 4.0
W_LIM = 2.0 * math.pi
EULER_LIM_DEG = 85.0
EIX_LIM = 3.0
EIB1_LIM = 3.0
SAT_SIGMA = 1.0
FREQ = 200
DT = 1.0 / FREQ


class StepOut(NamedTuple):
    obs: Tuple[torch.Tensor, ...]   # per agent: MODUL (15, 3), MONO (23,),
    #                                 quad (18,)
    reward: torch.Tensor     # (..., n_agents)
    done: torch.Tensor       # (..., n_agents) bool
    info: dict


def _ensure_R(cfg: Config, R):
    """R as a read sees it (quad.py:54-62): repaired where it has drifted
    under ``exact_so3``, as stored otherwise."""
    return so3.ensure_so3_exact(R) if cfg.exact_so3 else R


def action_quad(p: QuadParams, a):
    """Per-motor thrusts -> (f, M) (quad.py:68-80): the forces clipped, then
    ``forces_to_fM`` as a fixed-order 4x4 matvec."""
    forces = torch.clamp(p.scale_act[..., None] * a + p.avrg_act[..., None],
                         p.min_force[..., None], p.max_force[..., None])
    F = p.forces_to_fM
    fM = ((F[..., :, 0] * forces[..., 0:1] + F[..., :, 1] * forces[..., 1:2])
          + (F[..., :, 2] * forces[..., 2:3] + F[..., :, 3] * forces[..., 3:4]))
    return fM[..., 0], fM[..., 1:4], forces


def _f_total(p: QuadParams, a0):
    return torch.clamp(4.0 * (p.scale_act * a0 + p.avrg_act),
                       4.0 * p.min_force, 4.0 * p.max_force)


def action_coupled(p: QuadParams, a):
    """MONO: a = (f_total, M1, M2, M3) (quad.py:91-93)."""
    return _f_total(p, a[..., 0]), a[..., 1:4]


def action_decoupled(p: QuadParams, a):
    """MODUL: a = (f_total, tau1..3, M3) (quad.py:96-98)."""
    return _f_total(p, a[..., 0]), a[..., 1:4], a[..., 4]


class NormErr(NamedTuple):
    ex: torch.Tensor
    eIx: torch.Tensor
    ev: torch.Tensor
    eW: torch.Tensor
    eW3: torch.Tensor
    eb1: torch.Tensor
    eIb1: torch.Tensor
    R: torch.Tensor
    eIx_err: torch.Tensor
    eIx_integrand: torch.Tensor
    eIb1_err: torch.Tensor
    eIb1_integrand: torch.Tensor


def norm_error_state(cfg: Config, x, v, R, W, goal: Goal,
                     eIx_err, eIx_int, eIb1_err, eIb1_int) -> NormErr:
    """Normalized errors + leaky trapezoidal integrals (quad.py:120-164)."""
    dtype, device = x.dtype, x.device

    def const(c):
        return torch.tensor(c, dtype=dtype, device=device)

    R = _ensure_R(cfg, R)
    x_norm = x / X_LIM
    v_norm = v / V_LIM
    W_norm = W / W_LIM
    xd_norm = goal.xd / X_LIM
    vd_norm = goal.vd / V_LIM
    Wd_norm = goal.Wd / W_LIM
    ex = x_norm - xd_norm
    ev = v_norm - vd_norm
    eW = W_norm - Wd_norm
    eW3 = W_norm[..., 2] - Wd_norm[..., 2]
    b1 = R[..., :, 0]
    b2 = R[..., :, 1]
    b3 = R[..., :, 2]
    b1c = goal.b1d - dot3(goal.b1d, b3)[..., None] * b3
    eb1 = torch.atan2(-dot3(b1c, b2), dot3(b1c, b1))
    pi = const(math.pi)
    eb1_norm = eb1 / pi
    alpha, beta, dt = const(cfg.alpha), const(cfg.beta), const(DT)
    eIx_cur = -alpha * eIx_err + ex * X_LIM
    eIx_err = eIx_err + ((eIx_int + eIx_cur) * dt) / 2.0
    eIx_norm = torch.clamp(eIx_err / EIX_LIM, -SAT_SIGMA, SAT_SIGMA)
    eIb1_cur = -beta * eIb1_err + eb1_norm * pi
    eIb1_err = eIb1_err + ((eIb1_int + eIb1_cur) * dt) / 2.0
    eIb1_norm = torch.clamp(eIb1_err / EIB1_LIM, -SAT_SIGMA, SAT_SIGMA)
    return NormErr(ex=ex, eIx=eIx_norm, ev=ev, eW=eW, eW3=eW3, eb1=eb1_norm,
                   eIb1=eIb1_norm, R=R, eIx_err=eIx_err,
                   eIx_integrand=eIx_cur, eIb1_err=eIb1_err,
                   eIb1_integrand=eIb1_cur)


def build_obs(cfg: Config, ne: NormErr):
    """Per-agent observations (quad.py:167-184), cast to float32: MODUL
    ``(obs1 (15), obs2 (3))``; MONO ``(obs (23),)`` with R flattened
    column-major (``R_vec = [R00, R10, R20, R01, ...]``)."""
    if cfg.framework == "MONO":
        R_vec = ne.R.transpose(-1, -2).reshape(ne.R.shape[:-2] + (9,))
        obs = torch.cat([ne.ex, ne.eIx, ne.ev, R_vec, ne.eb1[..., None],
                         ne.eIb1[..., None], ne.eW], dim=-1)
        return (obs.to(torch.float32),)
    b1 = ne.R[..., :, 0]
    b2 = ne.R[..., :, 1]
    b3 = ne.R[..., :, 2]
    ew12 = ne.eW[..., 0, None] * b1 + ne.eW[..., 1, None] * b2
    obs1 = torch.cat([ne.ex, ne.eIx, ne.ev, b3, ew12], dim=-1)
    obs2 = torch.stack([ne.eb1, ne.eIb1, ne.eW3], dim=-1)
    return obs1.to(torch.float32), obs2.to(torch.float32)


def _sqnorm(x):
    n = so3.sqrt_rn(dot3(x, x))
    return n * n


def _interp01(r, rmin: float, wide: bool):
    """np.interp(r, [rmin, 0], [0, 1]) (quad.py:197-203).  The JAX package
    widens to float64 when x64 is on; the port widens on its float64 path
    (``wide``) and stays in float32 otherwise, which differs from
    JAX-with-x64 by at most an ulp of the float32 reward."""
    r = r.to(torch.float64) if wide else r
    slope = (1.0 - 0.0) / (0.0 - rmin)
    val = slope * (r - rmin) + 0.0
    return torch.clamp(val, 0.0, 1.0)


def reward_coupled(cfg: Config, obs):
    """MONO 6-term reward (quad.py:206-216)."""
    ex, eIx, ev = obs[..., 0:3], obs[..., 3:6], obs[..., 6:9]
    eb1, eIb1, eW = obs[..., 18], obs[..., 19], obs[..., 20:23]
    r = -cfg.Cx * _sqnorm(ex)
    r = r + -cfg.CIx * _sqnorm(eIx)
    r = r + -cfg.Cv * _sqnorm(ev)
    r = r + -cfg.Cb1 * torch.abs(eb1)
    aI = torch.abs(eIb1)
    r = r + -cfg.CIb1 * (aI * aI)
    r = r + -cfg.Cw12 * _sqnorm(eW)
    return r[..., None]


def done_coupled(obs):
    """MONO termination (quad.py:247-255): the full ``eW = obs[20:23]``."""
    ex, ev, eW = obs[..., 0:3], obs[..., 6:9], obs[..., 20:23]
    d = ((torch.abs(ex) >= 1.0).any(-1) | (torch.abs(ev) >= 1.0).any(-1)
         | (torch.abs(eW) >= 1.0).any(-1))
    return d[..., None]


def reward_decoupled(cfg: Config, obs1, obs2):
    """Per-agent rewards (quad.py:219-231)."""
    ex, eIx, ev = obs1[..., 0:3], obs1[..., 3:6], obs1[..., 6:9]
    ew12 = obs1[..., 12:15]
    r1 = -cfg.Cx * _sqnorm(ex)
    r1 = r1 + -cfg.CIx * _sqnorm(eIx)
    r1 = r1 + -cfg.Cv * _sqnorm(ev)
    r1 = r1 + -cfg.Cw12 * _sqnorm(ew12)
    eb1, eIb1, eW3 = obs2[..., 0], obs2[..., 1], obs2[..., 2]
    r2 = -cfg.Cb1 * torch.abs(eb1)
    aI = torch.abs(eIb1)
    r2 = r2 + -cfg.CIb1 * (aI * aI)
    aW = torch.abs(eW3)
    r2 = r2 + -cfg.CW3 * (aW * aW)
    return torch.stack([r1, r2], dim=-1)


def done_decoupled(obs1, obs2):
    """Per-agent termination (quad.py:258-267)."""
    ex, ev, ew12 = obs1[..., 0:3], obs1[..., 6:9], obs1[..., 12:15]
    d1 = ((torch.abs(ex) >= 1.0).any(-1) | (torch.abs(ev) >= 1.0).any(-1)
          | (torch.abs(ew12) >= 1.0).any(-1))
    d2 = torch.abs(obs2[..., 2]) >= 1.0
    return torch.stack([d1, d2], dim=-1)


def reward_quad(cfg: Config, x, v, R, W, goal: Goal):
    """The base env's reward on the raw errors (quad.py:234-245)."""
    eX = x - goal.xd
    eV = v - goal.vd
    eb1 = so3.norm_ang_btw_two_vectors(goal.b1d, so3.heading_b1(R))
    r = -cfg.Cx * _sqnorm(eX)
    r = r + -cfg.Cb1 * torch.abs(eb1)
    r = r + -cfg.Cv * _sqnorm(eV)
    r = r + -cfg.Cw12 * _sqnorm(W)
    return r[..., None]


def done_quad(x, v, R, W):
    """The base env's termination with the tilt limit (quad.py:270-284):
    roll or pitch of ``R`` at 85 degrees or more.  ``180 / pi`` is folded in
    float64 and rounded once to the state's dtype, as JAX's weak-typed
    Python float is."""
    r2d = torch.tensor(180.0 / math.pi, dtype=x.dtype, device=x.device)
    euler = so3.rot_to_euler(R) * r2d
    d = ((torch.abs(x) >= X_LIM).any(-1) | (torch.abs(v) >= V_LIM).any(-1)
         | (torch.abs(W) >= W_LIM).any(-1)
         | (torch.abs(euler[..., 0]) >= EULER_LIM_DEG)
         | (torch.abs(euler[..., 1]) >= EULER_LIM_DEG))
    return d[..., None]


def step(cfg: Config, state: EnvState, action,
         task: str = None) -> Tuple[EnvState, StepOut]:
    """One control tick (quad.py:287-386): action map, dynamics, obs,
    reward, done.  ``task`` defaults to ``cfg.framework``'s wrapper
    (MODUL ``decoupled``, MONO ``coupled``); ``"quad"`` is the base env:
    ``action`` is ``(..., 5)`` (decoupled) or ``(..., 4)``.  The base env
    observes the stepped state as stored, takes reward and done from R as
    read, and leaves the integrals alone."""
    if task is None:
        task = "decoupled" if cfg.framework == "MODUL" else "coupled"
    p = state.params
    dtype = state.x.dtype
    action = action.to(dtype)
    R_work = _ensure_R(cfg, state.R)
    W = state.W
    if task == "quad":
        f, M, _ = action_quad(p, action)
    elif task == "coupled":
        f, M = action_coupled(p, action)
    elif task == "decoupled":
        f, tau, M3 = action_decoupled(p, action)
        b1 = R_work[..., :, 0]
        b2 = R_work[..., :, 1]
        J3 = p.J[..., 2]
        M1 = dot3(b1, tau) + J3 * W[..., 2] * W[..., 1]
        M2 = dot3(b2, tau) - J3 * W[..., 2] * W[..., 0]
        M = torch.stack([M1, M2, M3], dim=-1)
    else:
        raise ValueError(f"unknown task {task!r}")

    dt = torch.tensor(DT, dtype=dtype, device=state.x.device)
    x_n, v_n, R_n, W_n = integrate(cfg.integrator, state.x, state.v, R_work,
                                   W, f, M, p, dt)
    if not cfg.exact_so3:
        R_n = so3.polar_fast(R_n)
    wide = dtype == torch.float64

    if task == "quad":
        R_read = _ensure_R(cfg, R_n)
        reward = reward_quad(cfg, x_n, v_n, R_read, W_n, state.goal)
        done = done_quad(x_n, v_n, R_read, W_n)
        reward = _interp01(reward, float(cfg.reward_min), wide)
        reward = torch.where(done, -1.0, reward).to(dtype)
        new_state = dataclasses.replace(state, x=x_n, v=v_n, R=R_n, W=W_n,
                                        f_total=f, M=M, t=state.t + 1)
        info = {"ex": x_n - state.goal.xd,
                "eb1": torch.zeros(x_n.shape[:-1], dtype=dtype,
                                   device=x_n.device)}
        obs = (pack_state(x_n, v_n, R_n, W_n),)
        return new_state, StepOut(obs=obs, reward=reward, done=done,
                                  info=info)

    ne = norm_error_state(cfg, x_n, v_n, R_n, W_n, state.goal, state.eIx,
                          state.eIx_integrand, state.eIb1,
                          state.eIb1_integrand)
    obs = build_obs(cfg, ne)
    if task == "coupled":
        (o,) = obs
        reward = _interp01(reward_coupled(cfg, o), float(cfg.reward_min), wide)
        done = done_coupled(o)
        info = {"ex": o[..., 0:3] * X_LIM, "eb1": o[..., 18] * math.pi}
    else:
        obs1, obs2 = obs
        reward = reward_decoupled(cfg, obs1, obs2)
        done = done_decoupled(obs1, obs2)
        reward = torch.stack([
            _interp01(reward[..., 0], float(cfg.reward_min_1), wide),
            _interp01(reward[..., 1], float(cfg.reward_min_2), wide)], dim=-1)
        info = {"ex": obs1[..., 0:3] * X_LIM, "eb1": obs2[..., 0] * math.pi}
    reward = torch.where(done, -1.0, reward).to(dtype)

    new_state = dataclasses.replace(
        state, x=x_n, v=v_n, R=R_n, W=W_n, eIx=ne.eIx_err,
        eIx_integrand=ne.eIx_integrand, eIb1=ne.eIb1_err,
        eIb1_integrand=ne.eIb1_integrand, f_total=f, M=M, t=state.t + 1)
    return new_state, StepOut(obs=obs, reward=reward, done=done, info=info)


def _init_ranges(cfg: Config, env_type: str, u_origin):
    """Initial-error magnitudes (quad.py:392-407)."""
    dtype, device = u_origin.dtype, u_origin.device

    def full(v):
        return torch.full_like(u_origin, v)
    if env_type == "eval":
        return full(0.4), full(0.0), full(0.0), full(0.0)
    if env_type != "train":
        raise ValueError(f"unknown env_type {env_type!r}")
    at_origin = u_origin < 0.2
    d2r = math.pi / 180.0

    def pick(v):
        return torch.where(at_origin, torch.zeros((), dtype=dtype, device=device),
                           torch.tensor(v, dtype=dtype, device=device))
    return pick(0.6), pick(V_LIM * 0.5), pick(50.0 * d2r), pick(W_LIM * 0.5)


def reset_state(cfg: Config, u, env_type: str = "train") -> EnvState:
    """Episode initialization (quad.py:410-442) from the base draws ``u``
    of shape ``(..., N_DRAWS)`` (slots UDM, AT_ORIGIN, RESET)."""
    dtype, device = u.dtype, u.device
    batch = u.shape[:-1]
    if cfg.use_UDM and env_type == "train":
        p = params_lib.randomize(u[..., D.UDM], cfg.UDM_percentage)
    else:
        p = params_lib.nominal(batch, dtype, device)
    init_x, init_v, init_R, init_W = _init_ranges(cfg, env_type,
                                                  u[..., D.AT_ORIGIN])
    r = uniform_in(u[..., D.RESET], -1.0, 1.0)
    x = r[..., 0:3] * init_x[..., None]
    v = r[..., 3:6] * init_v[..., None]
    W = r[..., 6:9] * init_W[..., None]
    roll_pitch = r[..., 9:11] * init_R[..., None]
    yaw = r[..., 11:12] * math.pi
    euler = torch.cat([roll_pitch, yaw], dim=-1)
    R = _ensure_R(cfg, so3.euler_to_rot(euler))
    return fresh_state(p, x, v, R, W)


def fresh_state(p: QuadParams, x, v, R, W) -> EnvState:
    """Post-reset state: zero integrals, hover wrench, default goal."""
    batch = x.shape[:-1]
    z3 = torch.zeros_like(x)
    zs = torch.zeros(batch, dtype=x.dtype, device=x.device)
    return EnvState(
        x=x, v=v, R=R, W=W, eIx=z3, eIx_integrand=z3.clone(), eIb1=zs,
        eIb1_integrand=zs.clone(), f_total=p.m * params_lib.G_STD,
        M=z3.clone(), goal=Goal.default(batch, x.dtype, x.device), params=p,
        t=torch.zeros(batch, dtype=torch.int32, device=x.device))


def initial_obs(cfg: Config, state: EnvState):
    """First observation after reset, with its one integral update."""
    ne = norm_error_state(cfg, state.x, state.v, state.R, state.W, state.goal,
                          state.eIx, state.eIx_integrand, state.eIb1,
                          state.eIb1_integrand)
    obs = build_obs(cfg, ne)
    state = dataclasses.replace(
        state, eIx=ne.eIx_err, eIx_integrand=ne.eIx_integrand,
        eIb1=ne.eIb1_err, eIb1_integrand=ne.eIb1_integrand)
    return state, obs


def set_goal(state: EnvState, xd, vd, b1d, b1d_dot, Wd) -> EnvState:
    """``set_goal_state`` (quad.py:486-488)."""
    return dataclasses.replace(state, goal=Goal(xd=xd, vd=vd, b1d=b1d,
                                                b1d_dot=b1d_dot, Wd=Wd))
