"""Rigid-body equations of motion and fixed-step integrators (port of
``gym_rotor_tpu/envs/dynamics.py``): ``euler``, ``rk4`` and ``dop853``,
one fixed step of the 12-stage Dormand-Prince 8th-order method, the
stand-in for the reference's ``solve_ivp(method='DOP853')``.

All arithmetic keeps the JAX package's association order, so the float64
path is bit-identical to it.  DOP853's coefficients are scipy's float64
tableau; each enters as ``dt * float(a)``, i.e. rounded once to the state
dtype, as JAX without x64 rounds its numpy scalars (under x64 JAX widens a
float32 DOP853 step to float64 there; the port stays in the state dtype).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops import so3
from .params import G_STD, QuadParams

mm3 = so3.mm3


def mv3(A, b):
    """3x3 (mat)·(vec) with fixed summation order."""
    return (A[..., :, 0] * b[..., 0:1] + A[..., :, 1] * b[..., 1:2]) \
        + A[..., :, 2] * b[..., 2:3]


def dot3(a, b):
    """3-vector dot with fixed summation order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


class Deriv(NamedTuple):
    x: torch.Tensor
    v: torch.Tensor
    R: torch.Tensor
    W: torch.Tensor


def eom(x, v, R, W, f, M, params: QuadParams) -> Deriv:
    """Equations of motion with the wrench (f, M) held over the step."""
    del x
    zf = torch.zeros_like(f)
    g_e3 = torch.stack([zf, zf, torch.full_like(f, G_STD)], dim=-1)
    v_dot = g_e3 - (f[..., None] * R[..., :, 2]) / params.m[..., None]
    R_dot = mm3(R, so3.hat(W))
    Jmat = torch.diag_embed(params.J)
    hW = so3.hat(W)
    t1 = mm3(-hW, Jmat)
    t2 = mv3(t1, W)
    W_dot = (t2 + M) * (1.0 / params.J)
    return Deriv(x=v, v=v_dot, R=R_dot, W=W_dot)


def _axpy(y, d: Deriv, a):
    return (y[0] + a * d.x, y[1] + a * d.v, y[2] + a * d.R, y[3] + a * d.W)


def euler_step(x, v, R, W, f, M, params, dt):
    d = eom(x, v, R, W, f, M, params)
    return _axpy((x, v, R, W), d, dt)


def rk4_step(x, v, R, W, f, M, params, dt):
    """Classical fixed-step RK4; ``dt`` is a 0-d tensor in the state dtype."""
    half = dt * 0.5
    k1 = eom(x, v, R, W, f, M, params)
    y2 = _axpy((x, v, R, W), k1, half)
    k2 = eom(*y2, f, M, params)
    y3 = _axpy((x, v, R, W), k2, half)
    k3 = eom(*y3, f, M, params)
    y4 = _axpy((x, v, R, W), k3, dt)
    k4 = eom(*y4, f, M, params)
    sixth = dt / 6.0
    third = dt / 3.0
    out = (x, v, R, W)
    out = _axpy(out, k1, sixth)
    out = _axpy(out, k2, third)
    out = _axpy(out, k3, third)
    out = _axpy(out, k4, sixth)
    return out


@functools.lru_cache(maxsize=None)
def dop853_tableau():
    """scipy's DOP853 Butcher tableau (``dop853_coefficients``): ``A``
    (12, 12), ``B`` (12,), ``C`` (12,), float64, no hand-typed constant."""
    import numpy as np
    from scipy.integrate._ivp import dop853_coefficients as dc

    n = dc.N_STAGES
    A = np.asarray(dc.A, dtype=np.float64)[:n, :n]
    B = np.asarray(dc.B, dtype=np.float64)
    C = np.asarray(dc.C, dtype=np.float64)[:n]
    return A, B, C


def dop853_step(x, v, R, W, f, M, params, dt):
    """One fixed step of the 12-stage Dormand-Prince 8th-order method:
    stage ``i`` starts from the state and adds ``(dt * a_ij) k_j`` for each
    nonzero ``a_ij`` in ``j`` order; the step adds ``(dt * b_i) k_i`` for
    each nonzero ``b_i`` (zeros skipped, as JAX skips them)."""
    A, B, _ = dop853_tableau()
    y0 = (x, v, R, W)
    ks = []
    for i in range(len(B)):
        yi = y0
        for j in range(i):
            if A[i, j] != 0.0:
                yi = _axpy(yi, ks[j], dt * float(A[i, j]))
        ks.append(eom(*yi, f, M, params))
    out = y0
    for i, bi in enumerate(B):
        if bi != 0.0:
            out = _axpy(out, ks[i], dt * float(bi))
    return out


_INTEGRATORS = {"euler": euler_step, "rk4": rk4_step, "dop853": dop853_step}


def integrate(name: str, x, v, R, W, f, M, params, dt, substeps: int = 1):
    if name not in _INTEGRATORS:
        raise ValueError(f"unknown integrator {name!r} "
                         f"(one of {sorted(_INTEGRATORS)})")
    step = _INTEGRATORS[name]
    h = dt / substeps
    y = (x, v, R, W)
    for _ in range(substeps):
        y = step(*y, f, M, params, h)
    return y
