"""SO(3) primitives on torch tensors (port of ``gym_rotor_tpu/ops/so3.py``).

Shape-polymorphic over leading batch dims and dtype-polymorphic (float32
fast path, float64 parity path).  Every 3x3 product is written as
fixed-order elementwise arithmetic (``mm3``), never as a matmul, so the
float64 path reproduces the JAX package bit for bit and the float32 path
never touches TF32.  ``ensure_so3_exact`` is the ``exact_so3`` path's
conditional repair.  ``psvd``/``project_so3_svd`` are plain
``torch.linalg.svd``: no env, learner or eval path calls them.
"""
from __future__ import annotations

import math

import torch


def sqrt_rn(x):
    """``sqrt`` correctly rounded in float32 too: a float32 input's root is
    taken in float64 and rounded once to float32 (exact, since 53 >= 2 * 24
    + 2: the double rounding cannot move the result), because torch's CPU
    float32 ``sqrt`` is not correctly rounded on some hosts, where numpy's
    and XLA's are.  Other dtypes go through ``torch.sqrt`` as they are."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def _stack3x3(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def hat(w):
    """R^3 -> so(3): (..., 3) -> (..., 3, 3)."""
    w1, w2, w3 = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(w1)
    return _stack3x3([[z, -w3, w2], [w3, z, -w1], [-w2, w1, z]])


def vee(M):
    """so(3) -> R^3, inverse of hat."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def cross(a, b):
    """Cross product with fixed operation order."""
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def inv3(M):
    """Closed-form 3x3 inverse via the adjugate."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = _stack3x3([
        [A, -(b * i - c * h), b * f - c * e],
        [B, a * i - c * g, -(a * f - c * d)],
        [C, -(a * h - b * g), a * e - b * d],
    ])
    return adj * inv_det[..., None, None]


def polar_fast(R, iters: int = 2):
    """Newton iteration R <- (R + R^{-T}) / 2 for the orthogonal polar
    factor (two iterations take drift of 1e-3 below 1e-9)."""
    for _ in range(iters):
        R = 0.5 * (R + inv3(R).transpose(-1, -2))
    return R


def psvd(A):
    """Proper SVD with the det-sign correction (``so3.py:68-87``): ``(U, s,
    V)`` with ``A = U diag(s) V^T`` and ``det U = det V = +1``.  SVD's sign
    conventions are LAPACK's, so U and V may differ from JAX's by the sign
    of a column pair; ``U V^T`` does not."""
    U, s, Vh = _svd_with_retry(A)
    detU = torch.linalg.det(U)
    detV = torch.linalg.det(Vh)
    U = U.clone()
    Vh = Vh.clone()
    s = s.clone()
    U[..., :, 2] = U[..., :, 2] * detU[..., None]
    Vh[..., 2, :] = Vh[..., 2, :] * detV[..., None]
    s[..., 2] = s[..., 2] * (detU * detV)
    return U, s, Vh.transpose(-1, -2)


def _svd_with_retry(A):
    """``torch.linalg.svd`` with JAX's per-matrix retry (``so3.py:90-101``):
    a matrix whose factors are not finite takes the decomposition of itself
    plus 1e-6 N(0, 1) noise from a fixed seed (JAX draws it from
    ``PRNGKey(0)``, which torch cannot reproduce).  torch raises on a
    non-finite input where XLA returns NaN factors."""
    U, s, Vh = torch.linalg.svd(A)
    bad = ~(torch.isfinite(U).all(-1).all(-1) & torch.isfinite(s).all(-1)
            & torch.isfinite(Vh).all(-1).all(-1))
    gen = torch.Generator(device=A.device).manual_seed(0)
    noise = 1e-6 * torch.randn(A.shape, generator=gen, dtype=A.dtype,
                               device=A.device)
    U2, s2, Vh2 = torch.linalg.svd(A + noise)
    m2 = bad[..., None, None]
    return (torch.where(m2, U2, U), torch.where(bad[..., None], s2, s),
            torch.where(m2, Vh2, Vh))


def project_so3_svd(R):
    """Nearest rotation ``U V^T`` by the proper SVD (``so3.py:104-107``)."""
    U, _, V = psvd(R)
    return U @ V.transpose(-1, -2)


def det3(M):
    """3x3 determinant as the cofactor expansion along the first row, in
    ``inv3``'s order."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) + b * (-(d * i - f * g)) + c * (d * h - e * g)


def is_rotation(R, tol: float = 1e-5):
    """The reference's drift check (``so3.py:110-121``): ``allclose(RᵀR, I,
    rtol=tol, atol=tol)`` and ``isclose(det R, 1, rtol=tol)``.  RᵀR is the
    fixed-order ``mm3`` and det the cofactor expansion ``det3``, where JAX
    takes ``@`` and an LU ``det``: the mask agrees except for an R whose
    RᵀR or det lies within an ulp of the 1e-5 edge."""
    dtype, device = R.dtype, R.device
    RtR = mm3(R.transpose(-1, -2), R)
    eye = torch.eye(3, dtype=dtype, device=device)
    t = torch.tensor(tol, dtype=dtype, device=device)
    ortho = (torch.abs(RtR - eye) <= t + t * eye).all(-1).all(-1)
    det_tol = torch.tensor(1e-8 + tol * 1.0, dtype=dtype, device=device)
    return ortho & (torch.abs(det3(R) - 1.0) <= det_tol)


def ensure_so3_exact(R, tol: float = 1e-5):
    """Repair on read (``so3.py:124-140``): R itself where it passes
    ``is_rotation``, else its polar factor by six Newton iterations."""
    ok = is_rotation(R, tol)
    return torch.where(ok[..., None, None], R, polar_fast(R, iters=6))


def rot_x(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return _stack3x3([[o, z, z], [z, c, -s], [z, s, c]])


def rot_y(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return _stack3x3([[c, z, s], [z, o, z], [-s, z, c]])


def rot_z(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return _stack3x3([[c, -s, z], [s, c, z], [z, z, o]])


def mm3(A, B):
    """3x3 matmul as elementwise ops with fixed left-to-right summation."""
    return (A[..., :, 0:1] * B[..., 0:1, :]
            + A[..., :, 1:2] * B[..., 1:2, :]) + A[..., :, 2:3] * B[..., 2:3, :]


def euler_to_rot(euler):
    """R = Rz @ Ry @ Rx (scipy ``from_euler('xyz')`` extrinsic)."""
    return mm3(rot_z(euler[..., 2]),
               mm3(rot_y(euler[..., 1]), rot_x(euler[..., 0])))


def rot_to_euler(R):
    """(roll, pitch, yaw) of ``R = Rz Ry Rx`` (``so3.py:238-249``), the
    singular branch (``sy < 1e-6``) as a select."""
    sy = sqrt_rn(R[..., 0, 0] * R[..., 0, 0]
                 + R[..., 1, 0] * R[..., 1, 0])
    singular = sy < 1e-6
    x_ns = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    z_ns = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    x_s = torch.atan2(-R[..., 1, 2], R[..., 1, 1])
    y = torch.atan2(-R[..., 2, 0], sy)
    x = torch.where(singular, x_s, x_ns)
    z = torch.where(singular, torch.zeros_like(z_ns), z_ns)
    return torch.stack([x, y, z], dim=-1)


def _heading(R):
    b1 = R[..., :, 0]
    return torch.atan2(b1[..., 1], b1[..., 0])


def heading_b1(R):
    """The body x-axis projected onto the horizontal plane, renormalised
    (``so3.py:252-259``)."""
    theta = _heading(R)
    return torch.stack([torch.cos(theta), torch.sin(theta),
                        torch.zeros_like(theta)], dim=-1)


def heading_rd(R):
    """The yaw-only rotation of ``R`` (``so3.py:262-266``)."""
    return rot_z(_heading(R))


def _unit(v):
    """``v / ||v||``, the norm as the fixed-order ``sqrt(dot3(v, v))``."""
    return v / sqrt_rn(_dot3(v, v))[..., None]


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def norm_ang_btw_two_vectors(desired, current):
    """Signed angle between two vectors over pi, in [-1, 1]
    (``so3.py:269-280``): ``arccos`` of the clipped dot of the unit vectors,
    negative where the cross product's z is; ``sign == 0`` keeps it
    positive."""
    du, cu = _unit(desired), _unit(current)
    ang = torch.acos(torch.clamp(_dot3(du, cu), -1.0, 1.0))
    ang = torch.where(cross(du, cu)[..., 2] < 0, -ang, ang)
    # a 0-d tensor, not a Python float: CUDA divides by a host scalar as a
    # multiplication by its reciprocal
    return ang / torch.tensor(math.pi, dtype=ang.dtype, device=ang.device)


def ang_btw_two_vectors(v1, v2):
    """Unsigned angle between two vectors (``so3.py:283-288``), 0 below
    1e-6."""
    ang = torch.acos(torch.clamp(_dot3(_unit(v1), _unit(v2)), -1.0, 1.0))
    return torch.where(ang < 1e-6, torch.zeros_like(ang), ang)
