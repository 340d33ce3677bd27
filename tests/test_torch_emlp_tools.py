"""The port's EMLP diagnostics and interface
(``gym_rotor_tpu_torch/models/emlp/diagnostics.py``, ``interface.py``)
against the JAX package's, with the same inputs, group samples (the same
seeded ``np.random.Generator``) and noise (JAX's draw passed in).

Tolerances: the host NumPy diagnostics (``scale_adjusted_rel_error``,
``equivariance_error``, ``equivariant_basis``) bit for bit;
``equivariant_projection`` and ``vis`` (float32 products) within 1e-6 and
1e-4 (``vis`` rounds to 4 decimals); ``sparsify_basis``'s rotation from
JAX's own ``W0`` within 1e-5 of optax's Adam at every checked step in
float32 and its snapped pattern equal; ``MLP``, ``group_augmentation``
and ``Interface`` (its scoped EMLP through ``emlp_apply``, K3's twins on
the CPU) within 1e-9 of max |JAX| in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from gym_rotor_tpu.models.emlp import diagnostics as jdiag
from gym_rotor_tpu.models.emlp import groups as jG
from gym_rotor_tpu.models.emlp import interface as jif
from gym_rotor_tpu.models.emlp import rep_algebra as jra
from gym_rotor_tpu.models.emlp import reps as jreps
from gym_rotor_tpu_torch import convert
from gym_rotor_tpu_torch.models.emlp import diagnostics as tdiag
from gym_rotor_tpu_torch.models.emlp import groups as tG
from gym_rotor_tpu_torch.models.emlp import interface as tif
from gym_rotor_tpu_torch.models.emlp import rep_algebra as tra
from gym_rotor_tpu_torch.models.emlp import reps as treps


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(
        float(np.abs(want).max()), 1e-300)


def _scoped(reps, G):
    """(rep_in, rep_out) of the scoped engine: 2V + 3 scalars -> V + 2
    scalars over ``G``."""
    return ((reps.Vector(G) * 2 + reps.Scalar(G) * 3),
            (reps.Vector(G) + reps.Scalar(G) * 2))


def test_diagnostics_match_jax():
    """``scale_adjusted_rel_error``; ``equivariance_error`` of a basis and
    of a single matrix (scoped reps over SO(3), general reps over SO(3)
    and across SO(2) and S(3)) from the same generator; ``equivariant_basis``, bit for
    bit; ``equivariant_projection`` within 1e-6 and its dimension; ``vis``
    within 1e-4."""
    rng = np.random.default_rng(0)
    t1, t2, g = rng.normal(size=(3, 4, 4))
    assert jdiag.scale_adjusted_rel_error(t1, t2, g) == \
        tdiag.scale_adjusted_rel_error(t1, t2, g)
    (ja, jb), (ta, tb) = _scoped(jreps, jG.SO(3)), _scoped(treps, tG.SO(3))
    Qj, Qt = jdiag.equivariant_basis(ja, jb), tdiag.equivariant_basis(ta, tb)
    assert Qj.dtype == Qt.dtype and Qj.tobytes() == Qt.tobytes()
    W = rng.normal(size=(jb.size, ja.size))
    for M in (Qj, W):
        assert jdiag.equivariance_error(M, ja, jb, rng=np.random.default_rng(5)) \
            == tdiag.equivariance_error(M, ta, tb,
                                        rng=np.random.default_rng(5))
    gj, gt = (ra.V(G.SO(3)) + ra.Scalar(G.SO(3)) for ra, G in
              ((jra, jG), (tra, tG)))
    Qg = (gt >> gt).equivariant_basis()
    assert jdiag.equivariance_error(Qg, gj, gj, rng=np.random.default_rng(2)) \
        == tdiag.equivariance_error(Qg, gt, gt, rng=np.random.default_rng(2))
    (aj, bj), (at, bt) = ((ra.V(G.SO(2)), ra.V(G.S(3))) for ra, G in
                          ((jra, jG), (tra, tG)))
    W = rng.normal(size=(3, 2))
    assert jdiag.equivariance_error(W, aj, bj, rng=np.random.default_rng(2)) \
        == tdiag.equivariance_error(W, at, bt, rng=np.random.default_rng(2))
    pj, rj = jdiag.equivariant_projection(ja, jb)
    pt, rt = tdiag.equivariant_projection(ta, tb)
    v = rng.normal(size=ja.size * jb.size)
    assert rj == rt and _rel(pt(v).numpy(), np.asarray(pj(v))) < 1e-6
    assert np.abs(jdiag.vis(ja, jb) - tdiag.vis(ta, tb)).max() <= 1e-4


def test_vis_writes_only_with_a_path(tmp_path):
    """``vis`` imports matplotlib only to save a picture."""
    ta, tb = _scoped(treps, tG.SO(2))
    path = tmp_path / "basis.png"
    img = tdiag.vis(ta, tb, str(path))
    assert img.shape == (tb.size, ta.size) and path.stat().st_size > 0


def test_sparsify_basis_tracks_optax():
    """The port's rotation after 1, 10 and 60 steps within 1e-5 of
    optax's Adam on the JAX package's loss, from the same ``W0`` (a
    rotation moved off orthogonality, and a generic orthonormal ``Q``, so
    that no |.| of the loss sits at its kink, where float32 rounding
    decides a gradient's sign: an exactly orthogonal start, as the JAX
    package's own ``W0``, puts every entry of WᵀW - I there); the snapped
    basis is that rotation's."""
    rng = np.random.default_rng(3)
    Q = np.linalg.qr(rng.normal(size=(24, 5)))[0].astype(np.float32)
    r = Q.shape[-1]
    W0 = (np.linalg.qr(rng.normal(size=(r, r)))[0]
          + 0.05 * rng.normal(size=(r, r))).astype(np.float32)
    Qj = jnp.asarray(Q)

    def loss(W):
        return (jnp.abs(Qj @ W.T).mean()
                + 0.1 * jnp.abs(W.T @ W - jnp.eye(r)).mean()
                + 0.01 * jnp.linalg.slogdet(W)[1] ** 2)
    opt = optax.adam(1e-2)

    @jax.jit
    def step(W, ost):
        g = jax.grad(loss)(W)
        up, ost = opt.update(g, ost)
        return optax.apply_updates(W, up), ost

    W, ost = jnp.asarray(W0), opt.init(jnp.asarray(W0))
    for k in range(1, 61):
        W, ost = step(W, ost)
        if k in (1, 10, 60):
            Wt, diverged = tdiag.sparsify_rotation(Q, W0, 1e-2, k)
            assert not diverged and Wt.dtype == torch.float32
            assert np.abs(Wt.numpy() - np.asarray(W)).max() < 1e-5, k
    snapped = (Q @ Wt.numpy().T).astype(np.float32)
    snapped[np.abs(snapped) < 1e-2] = 0.0
    snapped[snapped != 0] = np.sign(snapped[snapped != 0])
    assert np.array_equal(tdiag.sparsify_basis(Q, iters=60, W0=W0), snapped)


def test_mlp_and_standardize_match_jax():
    """The baseline ``MLP`` from flax's parameters (names, (in, out)
    kernels) in float64, through ``standardize`` with both kinds of
    statistics."""
    ja, jb = _scoped(jreps, jG.SO(3))
    ta, tb = _scoped(treps, tG.SO(3))
    jm = jdiag.MLP(ja, jb, ch=16, num_layers=2)
    x = np.random.default_rng(1).normal(size=(5, ja.size))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3),
                                              jnp.asarray(x)))
    tm = tdiag.MLP(ta, tb, ch=16, num_layers=2, dtype=torch.float64)
    tm.load_state_dict(convert.module_params_from_jax(params, tm))
    stats = (0.5, 2.0, -1.0, 3.0)
    for st in (stats[:2], stats):
        fj = jdiag.standardize(jm.apply, st)
        ft = tdiag.standardize(lambda p, v: tm(v), st)
        assert _rel(ft(None, torch.from_numpy(x)).detach().numpy(),
                    fj(params, jnp.asarray(x))) < 1e-9
    gen = torch.Generator().manual_seed(0)
    fresh = tdiag.MLP(ta, tb, ch=16, num_layers=2, generator=gen)
    assert float(fresh.Dense_0.bias.detach().abs().max()) == 0.0


def test_group_augmentation_matches_jax():
    """``group_augmentation`` of a fixed non-equivariant map over SO(3)
    with 3 samples a row, from the same generator: float64 within 1e-9."""
    G3j, G3t = jG.SO(3), tG.SO(3)
    rj, rt = jreps.Vector(G3j) * 2, treps.Vector(G3t) * 2
    x = np.random.default_rng(4).normal(size=(4, 6))

    def fj(v):
        n = (v * v).sum(-1, keepdims=True)
        return v * jnp.tanh(n) + 0.3 * v[..., ::-1]

    def ft(v):
        n = (v * v).sum(-1, keepdim=True)
        return v * torch.tanh(n) + 0.3 * torch.flip(v, (-1,))
    yj = jif.group_augmentation(fj, rj, rj, G3j, jnp.asarray(x), 3,
                                np.random.default_rng(8))
    yt = tif.group_augmentation(ft, rt, rt, G3t, torch.from_numpy(x), 3,
                                np.random.default_rng(8))
    assert _rel(yt.numpy(), yj) < 1e-9
    gs = G3t.samples(12, np.random.default_rng(8))
    assert torch.equal(yt, tif.group_augmentation(ft, rt, rt, G3t,
                                                  torch.from_numpy(x), 3,
                                                  gs=gs))


def test_interface_matches_jax():
    """``Interface`` over three SO(3) vectors (its frames' rank needs
    three; an io EMLP of 30 channels holds three vectors) around a fixed
    map, from flax's parameters, with JAX's noise draw passed in: float64
    within 1e-9; ``batched_gram_schmidt`` orthonormal."""
    Gj, Gt = jG.SO(3), tG.SO(3)
    rj, rt = jreps.Vector(Gj) * 3, treps.Vector(Gt) * 3

    def fj(v):
        return v * jnp.tanh((v * v).sum(-1, keepdims=True))

    def ft(v):
        return v * torch.tanh((v * v).sum(-1, keepdim=True))
    jm = jif.Interface(fj, rj, rj, Gj, io_ch=30)
    x = np.random.default_rng(6).normal(size=(5, 9))
    key = jax.random.PRNGKey(2)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.asarray(x), key))
    params["params"]["noise_scale"] = 1.0 + 0.1 * np.random.default_rng(
        0).normal(size=9)
    yj = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), key))
    z = np.array(jax.random.normal(key, (9,), jnp.float64))
    tm = tif.Interface(ft, rt, rt, Gt, io_ch=30, dtype=torch.float64)
    tm.load_state_dict(convert.module_params_from_jax(params, tm))
    with torch.no_grad():
        yt = tm(torch.from_numpy(x), torch.from_numpy(z))
    assert np.isfinite(yj).all() and _rel(yt.numpy(), yj) < 1e-9
    frames = torch.from_numpy(np.random.default_rng(7).normal(size=(4, 3, 3)))
    gs = tif.batched_gram_schmidt(frames)
    eye = torch.eye(3, dtype=gs.dtype).expand(4, 3, 3)
    assert torch.allclose(gs.transpose(1, 2) @ gs, eye, atol=1e-12)
    assert _rel(gs.numpy(), np.asarray(jif.batched_gram_schmidt(
        jnp.asarray(frames.numpy())))) < 1e-12
