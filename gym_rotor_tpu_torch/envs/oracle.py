"""NumPy oracle: the reference environment math with explicit, fixed-order
arithmetic (the port's own copy of ``gym_rotor_tpu/envs/oracle.py``).

Two roles:

1. **Bitwise anchor for the plain float64 env** -- every floating-point
   operation has the value and association order of the float64 path of
   ``envs/quad.py``/``dynamics.py``, so oracle and port trajectories agree
   bit for bit under the Euler configuration (outside the transcendentals,
   where libm and torch may differ in the last bit).
2. **Replay of the reference's RNG stream** -- ``reset`` consumes
   ``np.random`` (and Python ``random``) draws in exactly the order of the
   reference's reset (set_random_parameters -> sample_init_error -> state
   draws), so a fixed seed reproduces the reference's episode
   initializations.  The Gym API (``envs/gym_api.py``) resets through it.
"""
from __future__ import annotations

import random as _pyrandom

import numpy as np

from ..utils.config import Config

X_LIM = 1.0
V_LIM = 4.0
W_LIM = 2.0 * np.pi
EULER_LIM_DEG = 85.0
EIX_LIM = 3.0
EIB1_LIM = 3.0
DT = 1.0 / 200.0
G_STD = 9.81
M_NOMINAL, D_NOMINAL = 2.15, 0.23
J_NOMINAL = (0.022, 0.022, 0.035)
C_TF_NOMINAL, C_TW_NOMINAL = 0.0135, 2.2
MIN_FORCE = 0.5


def mm3(A, B):
    return (A[:, 0:1] * B[0:1, :] + A[:, 1:2] * B[1:2, :]) + A[:, 2:3] * B[2:3, :]


def mv3(A, b):
    return (A[:, 0] * b[0] + A[:, 1] * b[1]) + A[:, 2] * b[2]


def dot3(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def hat(w):
    return np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]]
    )


def psvd(A):
    """Proper SVD incl. the perturb-retry on non-convergence
    (reference quad_utils.py:226-240)."""
    try:
        U, s, VT = np.linalg.svd(A)
    except np.linalg.LinAlgError:
        # the reference perturbs with fresh global-RNG noise and retries
        # once (quad_utils.py:229-233); a second failure propagates, as there
        A = A + np.random.normal(0, 1e-6, A.shape)
        U, s, VT = np.linalg.svd(A)
    detU = np.linalg.det(U)
    detV = np.linalg.det(VT)
    U[:, 2] = U[:, 2] * detU
    VT[2, :] = VT[2, :] * detV
    s[2] = s[2] * detU * detV
    return U, s, VT.T


def is_rotation(R, tol=1e-5):
    RtR = R.T @ R
    I = np.eye(3)
    ortho = np.all(np.abs(RtR - I) <= tol + tol * I)
    det_ok = abs(np.linalg.det(R) - 1.0) <= 1e-8 + tol
    return bool(ortho and det_ok)


def inv3(M):
    """Closed-form 3x3 inverse — op-for-op mirror of ops.so3.inv3."""
    a, b, c = M[0, 0], M[0, 1], M[0, 2]
    d, e, f = M[1, 0], M[1, 1], M[1, 2]
    g, h, i = M[2, 0], M[2, 1], M[2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = np.array([
        [A, -(b * i - c * h), b * f - c * e],
        [B, a * i - c * g, -(a * f - c * d)],
        [C, -(a * h - b * g), a * e - b * d],
    ])
    return adj * inv_det


def polar_newton(R, iters=6):
    """Deterministic Newton polar iteration — mirror of ops.so3.polar_fast."""
    for _ in range(iters):
        R = 0.5 * (R + inv3(R).T)
    return R


def ensure_so3(R, tol=1e-5):
    """Conditional repair (reference quad_utils.py:123-142 semantics).
    Uses the deterministic polar iteration shared with the JAX env (see
    ops.so3.ensure_so3_exact for why not LAPACK SVD)."""
    if is_rotation(R, tol):
        return R
    return polar_newton(R, iters=6)


def euler_to_rot(euler):
    """R = Rz Ry Rx with fixed-order matmuls (quad_utils.py:180-196)."""
    a, b, c = euler[0], euler[1], euler[2]
    Rx = np.array([[1.0, 0.0, 0.0],
                   [0.0, np.cos(a), -np.sin(a)],
                   [0.0, np.sin(a), np.cos(a)]])
    Ry = np.array([[np.cos(b), 0.0, np.sin(b)],
                   [0.0, 1.0, 0.0],
                   [-np.sin(b), 0.0, np.cos(b)]])
    Rz = np.array([[np.cos(c), -np.sin(c), 0.0],
                   [np.sin(c), np.cos(c), 0.0],
                   [0.0, 0.0, 1.0]])
    return mm3(Rz, mm3(Ry, Rx))


class OracleParams:
    """Physical params + derived mixing (reference quad.py:359-406)."""

    def __init__(self, m, d, J1, J3, c_tf, c_tw):
        self.m, self.d, self.c_tf, self.c_tw = m, d, c_tf, c_tw
        self.J = np.array([J1, J1, J3])
        self.hover_force = m * G_STD / 4.0
        self.min_force = MIN_FORCE
        self.max_force = c_tw * self.hover_force
        self.avrg_act = (self.min_force + self.max_force) / 2.0
        self.scale_act = self.max_force - self.avrg_act
        self.forces_to_fM = np.array([
            [1.0, 1.0, 1.0, 1.0],
            [0.0, -d, 0.0, d],
            [d, 0.0, -d, 0.0],
            [-c_tf, c_tf, -c_tf, c_tf],
        ])
        self.fM_to_forces = np.linalg.inv(self.forces_to_fM)

    @classmethod
    def nominal(cls):
        return cls(M_NOMINAL, D_NOMINAL, J_NOMINAL[0], J_NOMINAL[2],
                   C_TF_NOMINAL, C_TW_NOMINAL)

    @classmethod
    def randomized(cls, pct):
        """Consumes 6 np.random.uniform draws in reference order
        (quad.py:368-387)."""
        u = pct / 100.0
        m = np.random.uniform(M_NOMINAL - M_NOMINAL * u, M_NOMINAL + M_NOMINAL * u)
        d = np.random.uniform(D_NOMINAL - D_NOMINAL * u, D_NOMINAL + D_NOMINAL * u)
        J1r = J_NOMINAL[0] * u
        J3r = J_NOMINAL[2] * u
        J1 = np.random.uniform(J_NOMINAL[0] - J1r, J_NOMINAL[0] + J1r)
        J3 = np.random.uniform(J_NOMINAL[2] - J3r, J_NOMINAL[2] + J3r)
        ctfr = C_TF_NOMINAL * u
        c_tf = np.random.uniform(C_TF_NOMINAL - ctfr, C_TF_NOMINAL + ctfr)
        ctwr = C_TW_NOMINAL * (u / 2.0)
        c_tw = np.random.uniform(C_TW_NOMINAL - ctwr, C_TW_NOMINAL + ctwr)
        return cls(m, d, J1, J3, c_tf, c_tw)


class OracleEnv:
    """Single-env NumPy simulator mirroring reference pipeline exactly."""

    def __init__(self, cfg: Config, task: str = None):
        self.cfg = cfg
        self.task = task or ("decoupled" if cfg.framework == "MODUL" else "coupled")
        self.p = OracleParams.nominal()
        self.x = np.zeros(3)
        self.v = np.zeros(3)
        self.R = np.eye(3)
        self.W = np.zeros(3)
        self.eIx = np.zeros(3)
        self.eIx_int = np.zeros(3)
        self.eIb1 = 0.0
        self.eIb1_int = 0.0
        self.xd = np.zeros(3)
        self.vd = np.zeros(3)
        self.b1d = np.array([1.0, 0.0, 0.0])
        self.b1d_dot = np.zeros(3)
        self.Wd = np.zeros(3)

    # -- reset (reference quad.py:171-222; RNG order preserved) -----------
    def reset(self, env_type="train"):
        cfg = self.cfg
        if cfg.use_UDM:
            self.p = (OracleParams.randomized(cfg.UDM_percentage)
                      if env_type == "train" else OracleParams.nominal())
        # sample_init_error (quad.py:338-356): yaw first, then branch.
        yaw = np.random.uniform(low=-np.pi, high=np.pi, size=1)
        d2r = np.pi / 180.0
        if env_type == "train":
            if _pyrandom.random() < 0.2:
                init_x = init_v = init_W = 0.0
                init_R = 0.0
            else:
                init_x, init_v = 0.6, V_LIM * 0.5
                init_R, init_W = 50.0 * d2r, W_LIM * 0.5
        else:
            init_x, init_v, init_R, init_W = 0.4, 0.0, 0.0, 0.0
        self.x = np.random.uniform(size=3, low=-init_x, high=init_x)
        self.v = np.random.uniform(size=3, low=-init_v, high=init_v)
        self.W = np.random.uniform(size=3, low=-init_W, high=init_W)
        roll_pitch = np.random.uniform(size=2, low=-init_R, high=init_R)
        euler = np.concatenate((roll_pitch, yaw), axis=None)
        R = euler_to_rot(euler)
        # isRotationMatrix (quad_utils.py:199-205): Frobenius norm check.
        if not np.linalg.norm(np.eye(3) - R.T @ R) < 1e-6:
            U, _, V = psvd(R)
            R = U @ V.T
        self.R = R
        self.eIx[:] = 0.0
        self.eIx_int[:] = 0.0
        self.eIb1 = 0.0
        self.eIb1_int = 0.0
        return self.state18()

    def state18(self):
        R_vec = self.R.T.reshape(9)  # column-major flatten
        return np.concatenate([self.x, self.v, R_vec, self.W])

    def set_goal(self, xd, vd, b1d, b1d_dot, Wd):
        self.xd, self.vd = np.asarray(xd, float), np.asarray(vd, float)
        self.b1d, self.b1d_dot = np.asarray(b1d, float), np.asarray(b1d_dot, float)
        self.Wd = np.asarray(Wd, float)

    # -- normalized error obs (reference quad.py:421-466) -----------------
    def norm_error_state(self):
        cfg = self.cfg
        R = ensure_so3(self.R)
        x_norm = self.x / X_LIM
        v_norm = self.v / V_LIM
        W_norm = self.W / W_LIM
        xd_norm = self.xd / X_LIM
        vd_norm = self.vd / V_LIM
        Wd_norm = self.Wd / W_LIM
        ex = x_norm - xd_norm
        ev = v_norm - vd_norm
        eW = W_norm - Wd_norm
        eW3 = W_norm[2] - Wd_norm[2]
        b1, b2, b3 = R[:, 0], R[:, 1], R[:, 2]
        b1c = self.b1d - dot3(self.b1d, b3) * b3
        eb1 = np.arctan2(-dot3(b1c, b2), dot3(b1c, b1))
        eb1_norm = eb1 / np.pi

        eIx_cur = -cfg.alpha * self.eIx + ex * X_LIM
        self.eIx = self.eIx + ((self.eIx_int + eIx_cur) * DT) / 2.0
        self.eIx_int = eIx_cur
        eIx_norm = np.clip(self.eIx / EIX_LIM, -1.0, 1.0)
        eIb1_cur = -cfg.beta * self.eIb1 + eb1_norm * np.pi
        self.eIb1 = self.eIb1 + ((self.eIb1_int + eIb1_cur) * DT) / 2.0
        self.eIb1_int = eIb1_cur
        eIb1_norm = np.clip(self.eIb1 / EIB1_LIM, -1.0, 1.0)

        if cfg.framework == "MODUL":
            ew12 = eW[0] * b1 + eW[1] * b2
            obs1 = np.concatenate([ex, eIx_norm, ev, b3, ew12]).astype(np.float32)
            obs2 = np.array([eb1_norm, eIb1_norm, eW3], dtype=np.float32)
            return obs1, obs2
        R_vec = R.T.reshape(9)
        obs = np.concatenate(
            [ex, eIx_norm, ev, R_vec, [eb1_norm], [eIb1_norm], eW]
        ).astype(np.float32)
        return obs

    # -- one Euler step (reference pipeline quad.py:142-168) --------------
    def step(self, action):
        cfg, p = self.cfg, self.p
        action = np.asarray(action, float)
        R_work = ensure_so3(self.R)
        if self.task == "coupled":
            f = np.clip(4.0 * (p.scale_act * action[0] + p.avrg_act),
                        4.0 * p.min_force, 4.0 * p.max_force)
            M = action[1:4]
        elif self.task == "decoupled":
            f = np.clip(4.0 * (p.scale_act * action[0] + p.avrg_act),
                        4.0 * p.min_force, 4.0 * p.max_force)
            tau, M3 = action[1:4], action[4]
            b1, b2 = R_work[:, 0], R_work[:, 1]
            M1 = dot3(b1, tau) + p.J[2] * self.W[2] * self.W[1]
            M2 = dot3(b2, tau) - p.J[2] * self.W[2] * self.W[0]
            M = np.array([M1, M2, M3])
        else:  # quad: per-motor thrusts
            forces = np.clip(p.scale_act * action + p.avrg_act,
                             p.min_force, p.max_force)
            F = p.forces_to_fM
            fM = ((F[:, 0] * forces[0] + F[:, 1] * forces[1])
                  + (F[:, 2] * forces[2] + F[:, 3] * forces[3]))
            f, M = fM[0], fM[1:4]

        # Explicit Euler (quad.py:252-262), fixed-order arithmetic.
        x_dot = self.v
        g_e3 = np.array([0.0, 0.0, G_STD])
        v_dot = g_e3 - (f * R_work[:, 2]) / p.m
        R_dot = mm3(R_work, hat(self.W))
        Jmat = np.diag(p.J)
        t2 = mv3(mm3(-hat(self.W), Jmat), self.W)
        W_dot = (t2 + M) * (1.0 / p.J)

        self.x = self.x + x_dot * DT
        self.v = self.v + v_dot * DT
        self.R = R_work + R_dot * DT
        self.W = self.W + W_dot * DT
        self.f_total, self.M_applied = f, M

        if self.task == "quad":
            # base Quad-v0 (quad.py:245-318, with the scalar-indexing bug of
            # the reference's base step fixed): obs = raw next state,
            # reward/done on unnormalized errors
            obs = self.state18()
            r = self._reward_quad()
            r = _interp01(r, float(self.cfg.reward_min))
            d = self._done_quad()
            if d:
                r = -1.0
            return obs, np.array([r]), np.array([d])

        obs = self.norm_error_state()
        if self.task == "coupled":
            o = obs
            r = self._reward_coupled(o)
            r = _interp01(r, float(cfg.reward_min))
            d = self._done_coupled(o)
            if d:
                r = -1.0
            return obs, np.array([r]), np.array([d])
        elif self.task == "decoupled":
            o1, o2 = obs
            r1, r2 = self._reward_decoupled(o1, o2)
            r1 = _interp01(r1, float(cfg.reward_min_1))
            r2 = _interp01(r2, float(cfg.reward_min_2))
            d1, d2 = self._done_decoupled(o1, o2)
            if d1:
                r1 = -1.0
            if d2:
                r2 = -1.0
            return obs, np.array([r1, r2]), np.array([d1, d2])
        else:
            raise NotImplementedError("oracle step only for wrapper tasks")

    # -- rewards from float32 obs (coupled:78-92 / decoupled:92-113) -------
    def _reward_coupled(self, o):
        cfg = self.cfg
        ex, eIx, ev = o[0:3], o[3:6], o[6:9]
        eb1, eIb1, eW = o[18], o[19], o[20:23]
        r = -cfg.Cx * _sqnorm(ex)
        r = r + -cfg.CIx * _sqnorm(eIx)
        r = r + -cfg.Cv * _sqnorm(ev)
        r = r + -cfg.Cb1 * abs(eb1)
        r = r + -cfg.CIb1 * (abs(eIb1) ** 2)
        r = r + -cfg.Cw12 * _sqnorm(eW)
        return r

    def _reward_decoupled(self, o1, o2):
        cfg = self.cfg
        ex, eIx, ev, ew12 = o1[0:3], o1[3:6], o1[6:9], o1[12:15]
        r1 = -cfg.Cx * _sqnorm(ex)
        r1 = r1 + -cfg.CIx * _sqnorm(eIx)
        r1 = r1 + -cfg.Cv * _sqnorm(ev)
        r1 = r1 + -cfg.Cw12 * _sqnorm(ew12)
        eb1, eIb1, eW3 = o2[0], o2[1], o2[2]
        r2 = -cfg.Cb1 * abs(eb1)
        r2 = r2 + -cfg.CIb1 * (abs(eIb1) ** 2)
        r2 = r2 + -cfg.CW3 * (abs(eW3) ** 2)
        return r1, r2

    def _reward_quad(self):
        """Base reward on raw errors (quad.py:274-298)."""
        cfg = self.cfg
        R = ensure_so3(self.R)
        eX = self.x - self.xd
        eV = self.v - self.vd
        b1 = R[:, 0]
        theta = np.arctan2(b1[1], b1[0])
        b1_proj = np.array([np.cos(theta), np.sin(theta), 0.0])
        du = self.b1d / np.linalg.norm(self.b1d)
        cu = b1_proj / np.linalg.norm(b1_proj)
        dotp = np.clip(dot3(du, cu), -1.0, 1.0)
        ang = np.arccos(dotp)
        if np.sign(np.cross(du, cu)[2]) < 0:
            ang = -ang
        eb1 = ang / np.pi  # normalized signed angle (quad_utils.py:157-177)
        r = -cfg.Cx * _sqnorm(eX)
        r = r + -cfg.Cb1 * abs(eb1)
        r = r + -cfg.Cv * _sqnorm(eV)
        r = r + -cfg.Cw12 * _sqnorm(self.W)
        return r

    def _done_quad(self):
        """Base termination incl. Euler tilt limit (quad.py:301-318)."""
        R = ensure_so3(self.R)
        sy = np.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
        if sy < 1e-6:
            roll = np.arctan2(-R[1, 2], R[1, 1])
            pitch = np.arctan2(-R[2, 0], sy)
        else:
            roll = np.arctan2(R[2, 1], R[2, 2])
            pitch = np.arctan2(-R[2, 0], sy)
        r2d = 180.0 / np.pi
        return bool(
            (np.abs(self.x) >= X_LIM).any()
            or (np.abs(self.v) >= V_LIM).any()
            or (np.abs(self.W) >= W_LIM).any()
            or abs(roll * r2d) >= EULER_LIM_DEG
            or abs(pitch * r2d) >= EULER_LIM_DEG)

    def _done_coupled(self, o):
        ex, ev, eW = o[0:3], o[6:9], o[20:23]
        return bool((np.abs(ex) >= 1.0).any() or (np.abs(ev) >= 1.0).any()
                    or (np.abs(eW) >= 1.0).any())

    def _done_decoupled(self, o1, o2):
        ex, ev, ew12 = o1[0:3], o1[6:9], o1[12:15]
        d1 = bool((np.abs(ex) >= 1.0).any() or (np.abs(ev) >= 1.0).any()
                  or (np.abs(ew12) >= 1.0).any())
        d2 = bool(np.abs(o2[2]) >= 1.0)
        return d1, d2


def _sqnorm(v):
    n = np.sqrt(dot3(v, v))
    return n * n


def _interp01(r, rmin):
    slope = (1.0 - 0.0) / (0.0 - rmin)
    val = slope * (np.float64(r) - rmin) + 0.0
    return float(np.clip(val, 0.0, 1.0))


def seed_all(seed: int):
    """Mirror reference utils/utils.py:8-18 RNG seeding (python + numpy)."""
    _pyrandom.seed(seed)
    np.random.seed(seed)
