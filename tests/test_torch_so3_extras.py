"""PyTorch port vs the JAX package: the SO(3) helpers the ``quad`` task,
the Gym API and the reference eval stream need (``ops/so3.py``): ``psvd``
and ``project_so3_svd`` (plain ``torch.linalg.svd``, not kernels) with the
perturbed retry, ``rot_to_euler`` with its singular branch, ``heading_b1``
/ ``heading_rd``, ``norm_ang_btw_two_vectors`` (``sign == 0`` kept
positive) and ``ang_btw_two_vectors``.

Tolerances, float64: the singular values, the reconstruction and
``U V^T`` within 1e-12 (LAPACK builds may differ in the last bits and
choose other signs for a singular-vector pair, which the det correction
and ``U V^T`` do not see); the transcendentals (``atan2``, ``cos``,
``sin``, ``arccos``) within 4 ulp of 1, as XLA's CPU libm and torch's
differ in the last bit; the selects (singular branch, the sign) exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_rotor_tpu.ops import so3 as jso3
from gym_rotor_tpu_torch.ops import so3 as tso3

torch.set_num_threads(1)
ULP4 = 4 * np.spacing(1.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _rotations(rng, n):
    return _np(tso3.euler_to_rot(_t(rng.uniform(-np.pi, np.pi, (n, 3)))))


def test_psvd_matches_jax():
    """Random and drifted near-rotation matrices: singular values, proper
    factors (det +1), reconstruction and the projection ``U V^T``."""
    rng = np.random.default_rng(0)
    A = np.concatenate([rng.normal(size=(8, 3, 3)),
                        _rotations(rng, 8) + 1e-3 * rng.normal(size=(8, 3, 3))])
    U, s, V = tso3.psvd(_t(A))
    jU, js, jV = (np.asarray(x) for x in jso3.psvd(jnp.asarray(A)))
    np.testing.assert_allclose(_np(s), js, rtol=0, atol=1e-12)
    recon = _np(U @ (s[..., None] * V.transpose(-1, -2)))
    np.testing.assert_allclose(recon, A, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(_np(U)), 1.0, atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(_np(V)), 1.0, atol=1e-12)
    np.testing.assert_allclose(_np(U @ V.transpose(-1, -2)),
                               jU @ np.swapaxes(jV, -1, -2), rtol=0, atol=1e-12)
    P = _np(tso3.project_so3_svd(_t(A[8:])))
    np.testing.assert_allclose(P, np.asarray(jso3.project_so3_svd(
        jnp.asarray(A[8:]))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.einsum("nji,njk->nik", P, P),
                               np.broadcast_to(np.eye(3), P.shape), atol=1e-12)


def test_psvd_retry_substitutes_perturbed_decomposition(monkeypatch):
    """A matrix whose factors come back non-finite takes the decomposition
    of its perturbed copy; the other matrices keep theirs bitwise."""
    rng = np.random.default_rng(6)
    A = _t(rng.normal(size=(4, 3, 3)))
    U0, s0, Vh0 = torch.linalg.svd(A)
    real = torch.linalg.svd
    calls = {"n": 0}

    def flaky(M, *a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            U_bad = U0.clone()
            U_bad[2] = float("nan")
            return U_bad, s0, Vh0
        return real(M, *a, **k)
    monkeypatch.setattr(torch.linalg, "svd", flaky)
    U, s, Vh = tso3._svd_with_retry(A)
    assert calls["n"] == 2 and torch.isfinite(U).all()
    for k in (0, 1, 3):
        assert torch.equal(U[k], U0[k]) and torch.equal(Vh[k], Vh0[k])
    recon = U[2] @ (s[2][:, None] * Vh[2])
    np.testing.assert_allclose(_np(recon), _np(A[2]), rtol=0, atol=1e-4)
    assert not torch.equal(s[2], s0[2])


def test_rot_to_euler_matches_jax():
    """Random attitudes and the singular branch (pitch +-90 degrees, where
    ``sy < 1e-6`` and roll comes from R[1, 2], R[1, 1] with yaw 0)."""
    rng = np.random.default_rng(1)
    eul = rng.uniform(-np.pi, np.pi, (32, 3))
    eul[:, 1] /= 2.0
    eul[:4, 1] = [np.pi / 2, -np.pi / 2, np.pi / 2, -np.pi / 2]
    R = _np(tso3.euler_to_rot(_t(eul)))
    got = _np(tso3.rot_to_euler(_t(R)))
    ref = np.asarray(jso3.rot_to_euler(jnp.asarray(R)))
    sy = np.sqrt(R[:, 0, 0] ** 2 + R[:, 1, 0] ** 2)
    assert (sy[:4] < 1e-6).all() and (sy[4:] >= 1e-6).all()
    np.testing.assert_array_equal(got[:4, 2], 0.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ULP4 * np.pi)
    # away from the singular branch it inverts euler_to_rot
    np.testing.assert_allclose(got[4:], eul[4:], rtol=0, atol=1e-12)


def test_headings_match_jax():
    rng = np.random.default_rng(2)
    R = _rotations(rng, 32)
    for name in ("heading_b1", "heading_rd"):
        got = _np(getattr(tso3, name)(_t(R)))
        ref = np.asarray(getattr(jso3, name)(jnp.asarray(R)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=ULP4, err_msg=name)
    h = _np(tso3.heading_b1(_t(R)))
    np.testing.assert_array_equal(h[:, 2], 0.0)
    np.testing.assert_allclose(np.linalg.norm(h, axis=1), 1.0, atol=1e-15)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_norm_ang_btw_two_vectors_matches_jax(dtype):
    """Pairs whose cross product has z = 0 exactly (``sign == 0``): equal
    (angle 0), opposite (angle pi kept positive: +1, not -1), two vectors
    in a vertical plane; then random pairs, some near-parallel.  Within 4
    ulp of 1, plus, where |dot| > 1 - 1e-3, arccos' conditioning at its
    poles: a dot rounded 2 ulp apart (the norms, the 3-term sum in the
    order XLA picks) moves the angle by up to sqrt(2 * 2 ulp)."""
    rng = np.random.default_rng(3)
    d = rng.normal(size=(32, 3))
    c = rng.normal(size=(32, 3))
    d[0], c[0] = [1.0, 0.0, 0.0], [1.0, 0.0, 0.0]
    d[1], c[1] = [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]
    d[2], c[2] = [1.0, 0.0, 0.3], [2.0, 0.0, -1.0]
    c[3:6] = d[3:6] * [[1.0], [-2.0], [0.5]] + 1e-4 * rng.normal(size=(3, 3))
    d, c = d.astype(dtype), c.astype(dtype)
    got = _np(tso3.norm_ang_btw_two_vectors(_t(d), _t(c)))
    ref = np.asarray(jso3.norm_ang_btw_two_vectors(jnp.asarray(d),
                                                   jnp.asarray(c)))
    assert got.dtype == ref.dtype == dtype
    ulp = np.spacing(dtype(1))
    dots = np.einsum("ni,ni->n", d / np.linalg.norm(d, axis=1)[:, None],
                     c / np.linalg.norm(c, axis=1)[:, None])
    tol = 4 * ulp + np.where(np.abs(dots) > 1 - 1e-3,
                             np.sqrt(4 * ulp) / np.pi, 0.0)
    assert np.all(np.abs(got - ref) <= tol), np.abs(got - ref).max()
    assert got[0] == ref[0] == 0.0
    assert got[1] == ref[1] == 1.0
    assert got[2] > 0 and ref[2] > 0
    # the sign where the angle is resolved (0 < |angle| < 1 beyond tol)
    clear = (np.abs(ref) > tol) & (np.abs(ref) < 1 - tol)
    assert (np.sign(got[clear]) == np.sign(ref[clear])).all()


def test_ang_btw_two_vectors_matches_jax():
    """Unsigned angles; below 1e-6 they are exactly 0."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(32, 3))
    b = rng.normal(size=(32, 3))
    b[0] = 3.0 * a[0]
    b[1] = a[1] + 1e-9 * rng.normal(size=3)
    got = _np(tso3.ang_btw_two_vectors(_t(a), _t(b)))
    ref = np.asarray(jso3.ang_btw_two_vectors(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ULP4 * np.pi)
    assert got[0] == ref[0] == 0.0 and got[1] == ref[1] == 0.0
