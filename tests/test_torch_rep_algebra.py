"""The port's representation algebra
(``gym_rotor_tpu_torch/models/emlp/rep_algebra.py``) against the JAX
package's.

Tolerances: canonical orders, permutations, sizes, dense constraint
matrices and the dense (NumPy SVD) bases and projectors bit for bit (the
same host NumPy on both sides); the bilinear layer's sampled index sets
bit for bit, its dense ``W(x)`` in float64 within 1e-12 of JAX's and its
nonzero form within 1e-12 of the dense map; the matrix-free constraint
applies within 1e-12 of the dense matrix, on NumPy and on torch inputs;
the iterative solver's bases (a torch loop, whose bits are not XLA's) the
same subspace as JAX's iterative basis and as the dense basis, as the JAX
tests bound it: ``subspace_gap`` < 1e-4, the same shape.
"""
import numpy as np
import pytest
import torch

from gym_rotor_tpu.models.emlp import groups as jG
from gym_rotor_tpu.models.emlp import rep_algebra as jra
from gym_rotor_tpu_torch.models.emlp import groups as tG
from gym_rotor_tpu_torch.models.emlp import rep_algebra as tra


def subspace_gap(Qa, Qb):
    """Max |P_a - P_b| of the two orthogonal projectors: 0 iff the bases
    span the same subspace."""
    Pa = Qa @ Qa.conj().T
    Pb = Qb @ Qb.conj().T
    return np.abs(Pa - Pb).max()


def both(mk):
    """``mk(ra, G)`` built from the JAX package's algebra and the port's."""
    return mk(jra, jG), mk(tra, tG)


# rep expressions over groups whose canonical orders never fall to a hash
# tie-break (a tie is process-dependent in the JAX package)
REPS = {
    "so3_sum": lambda ra, G: (ra.V + ra.V ** 2 + ra.Scalar + ra.V)(G.SO(3)),
    "o3_product_of_sums": lambda ra, G: ((ra.V + ra.Scalar)
                                         * (ra.V + 2 * ra.Scalar))(G.O(3)),
    "sl2_dual": lambda ra, G: (ra.V * ra.V.t() + ra.V.t() + ra.V)(G.SL(2)),
    "s3_t3": lambda ra, G: ra.T(3, G=G.S(3)),
    "cross_group": lambda ra, G: ra.V(G.SO(2)) * ra.V(G.S(3)),
    "o2_maps": lambda ra, G: (ra.V >> (ra.V + ra.Scalar))(G.O(2)),
    "so3_maps": lambda ra, G: ((2 * ra.V + ra.Scalar)
                               >> (ra.V ** 2 + ra.V))(G.SO(3)),
    "so3_dual_of_sum": lambda ra, G: (ra.V + ra.Scalar + ra.V ** 2)(
        G.SO(3)).t(),
    "u2_t11": lambda ra, G: ra.T(1, 1, G=G.U(2)),
}


def _layout(rep):
    reps = rep.reps.items() if hasattr(rep, "reps") else [(rep, 1)]
    return [(repr(r), c, r.size()) for r, c in reps]


@pytest.mark.parametrize("name", sorted(REPS))
def test_canonical_layout_matches_jax(name):
    """repr, size, the canonical reps in order with their counts, ``perm``
    and ``invperm``, and ``canonicalize()``'s (rep, perm), bit for bit."""
    a, b = both(REPS[name])
    assert (repr(a), a.size(), type(a).__name__) == \
        (repr(b), b.size(), type(b).__name__)
    assert _layout(a) == _layout(b)
    for f in ("perm", "invperm"):
        if hasattr(a, f):
            assert np.array_equal(getattr(a, f), getattr(b, f))
    (ca, pa), (cb, pb) = a.canonicalize(), b.canonicalize()
    assert _layout(ca) == _layout(cb) and np.array_equal(pa, pb)


@pytest.mark.parametrize("name", ["so3_sum", "o3_product_of_sums",
                                  "sl2_dual", "s3_t3", "o2_maps",
                                  "so3_maps", "u2_t11"])
def test_dense_basis_matches_jax_bitwise(name):
    """``constraint_matrix`` of the canonical rep, ``equivariant_basis``
    and ``equivariant_projector`` (NumPy SVD path), bit for bit."""
    a, b = both(REPS[name])
    ca, cb = a.canonicalize()[0], b.canonicalize()[0]
    if not hasattr(ca, "reps") or len(ca.reps) == 1:
        assert ca.constraint_matrix().tobytes() == \
            cb.constraint_matrix().tobytes()
    for f in ("equivariant_basis", "equivariant_projector"):
        x, y = getattr(a, f)(), getattr(b, f)()
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes(), f


def test_direct_product_basis_and_algebra_match_jax():
    """The cross-group ``DirectProduct`` basis (the Kronecker of its
    factors') bit for bit; ``groups_of``, ``__call__`` on deferred reps,
    ``T(p, q)`` and ``<<``/``**`` as the JAX package's."""
    a, b = both(REPS["cross_group"])
    assert a.equivariant_basis().tobytes() == b.equivariant_basis().tobytes()
    assert [repr(g) for g in jra.groups_of(a)] == \
        [repr(g) for g in tra.groups_of(b)]
    for mk in (lambda ra, G: ra.T(2, 1, G=G.SO(3)),
               lambda ra, G: (ra.V << ra.V ** 2)(G.O(2)),
               lambda ra, G: ((ra.V + ra.Scalar) ** 2)(G.Z(3)),
               lambda ra, G: ra.T(0, G=G.SO(3)) + ra.V(G.SO(3))):
        x, y = both(mk)
        assert (repr(x), x.size()) == (repr(y), y.size())
        assert np.array_equal(x.perm, y.perm)


@pytest.mark.parametrize("mk", [
    lambda ra, G: ra.V(G.SO(3)) ** 3,
    lambda ra, G: (ra.V + ra.V * ra.V)(G.O(3)),
    lambda ra, G: ra.T(2, G=G.Z(5)),
    lambda ra, G: ra.T(3, G=G.S(4)),
    lambda ra, G: ra.T(2, G=G.SU(2)),
], ids=["so3_t3", "o3_sum", "z5_t2", "s4_t3", "su2_t2"])
def test_constraint_ops_match_jax(mk):
    """Each blockwise apply (and its adjoint) on a NumPy input within
    1e-12 of JAX's on the same input and the stacked applies of the dense
    ``constraint_matrix``; on a torch float64 (complex128) input the same
    numbers as on the NumPy one."""
    a, b = both(mk)
    ca, cb = a.canonicalize()[0], b.canonicalize()[0]
    C = cb.constraint_matrix()
    rng = np.random.default_rng(1)
    X = rng.standard_normal((cb.size(), 3))
    ops_a, ops_b = ca.constraint_ops(), cb.constraint_ops()
    assert len(ops_a) == len(ops_b)
    stacked = np.concatenate([np.asarray(f(X)) for f, _ in ops_b])
    assert np.abs(stacked - C @ X).max() < 1e-12
    Xt = torch.from_numpy(X)
    for (fa, ha), (fb, hb) in zip(ops_a, ops_b):
        for p, q in ((fa, fb), (ha, hb)):
            want = np.asarray(p(X))
            got = q(X)
            assert np.abs(got - want).max() < 1e-12
            assert np.abs(q(Xt).numpy() - got).max() < 1e-12


def test_iterative_matches_dense_span_real():
    """T(3) over SO(3): the port's iterative basis spans JAX's iterative
    basis's and the dense basis's subspace."""
    ca, cb = (r.canonicalize()[0] for r in both(
        lambda ra, G: ra.T(3, G=G.SO(3))))
    Qd = tra.orthogonal_complement(cb.constraint_matrix())
    Qj = jra.iterative_constraint_solve(ca)
    Qi = tra.iterative_constraint_solve(cb)
    assert Qi.shape == Qd.shape == Qj.shape
    assert subspace_gap(Qd, Qi) < 1e-4 and subspace_gap(Qj, Qi) < 1e-4


def test_iterative_matches_dense_span_complex():
    """T(2) over SU(2) (complex generators): a complex basis of the dense
    and JAX's iterative subspace."""
    ca, cb = (r.canonicalize()[0] for r in both(
        lambda ra, G: ra.T(2, G=G.SU(2))))
    Qd = tra.orthogonal_complement(cb.constraint_matrix())
    Qj = jra.iterative_constraint_solve(ca)
    Qi = tra.iterative_constraint_solve(cb)
    assert np.iscomplexobj(Qi)
    assert Qi.shape == Qd.shape == Qj.shape
    assert subspace_gap(Qd, Qi) < 1e-4 and subspace_gap(Qj, Qi) < 1e-4


def test_iterative_routing_past_cap(monkeypatch):
    """``equivariant_basis`` of T(4) over SO(3) switches to the iterative
    solver past ``MAX_DENSE_ENTRIES`` (monkeypatched, as the JAX test does)
    and returns the same subspace as the dense route and as JAX's
    iterative route, through canonicalization and ``perm``."""
    a, b = both(lambda ra, G: ra.T(4, G=G.SO(3)))
    tra.solcache.clear()
    Qd = b.equivariant_basis()
    tra.solcache.clear()
    jra.solcache.clear()
    monkeypatch.setattr(tra, "MAX_DENSE_ENTRIES", 1e3)
    monkeypatch.setattr(jra, "MAX_DENSE_ENTRIES", 1e3)
    Qi = b.equivariant_basis()
    Qj = a.equivariant_basis()
    tra.solcache.clear()
    jra.solcache.clear()
    assert Qd.shape == Qi.shape == Qj.shape
    assert subspace_gap(Qd, Qi) < 1e-4 and subspace_gap(Qj, Qi) < 1e-4


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


BILINEAR = {
    "so3_gated": lambda ra, G: (3 * ra.V + ra.V ** 2 + 4 * ra.Scalar)(
        G.SO(3)),
    "s4_regular": lambda ra, G: (2 * ra.V + ra.V ** 2 + ra.Scalar)(G.S(4)),
    "mirror2": lambda ra, G: (5 * ra.V + 2 * ra.Scalar)(G.Mirror(2)),
    "o2_reordered": lambda ra, G: (ra.V ** 2 + ra.Scalar + ra.V
                                   + ra.Scalar)(G.O(2)),
}


@pytest.mark.parametrize("name", sorted(BILINEAR))
def test_bilinear_weights_match_jax(name):
    """``bilinear_weights(rep, rep)``: the parameter count and every
    type's sampled coordinates (``np.random.default_rng(0)``, with
    replacement) bit for bit; ``W(x)`` in float64 within 1e-12 of JAX's on
    the same parameters and rows; ``bilinear_nonzeros`` summed over its
    entries within 1e-12 of ``W(x) x``."""
    a, b = both(BILINEAR[name])
    na, pa = jra.bilinear_weights(a, a)
    nb, pb = tra.bilinear_weights(b, b)
    assert na == nb
    ra = _closure(pa)["reduced"]
    _, _, rb, _, _ = tra.bilinear_layout(b, b)
    assert [repr(r) for r in ra] == [repr(r) for r in rb]
    for (r, ia), ib in zip(ra.items(), rb.values()):
        assert np.array_equal(ia, ib), r
    rng = np.random.default_rng(2)
    params = rng.standard_normal(na)
    x = rng.standard_normal((5, a.size()))
    Wa = np.asarray(pa(params, x))
    Wb = pb(torch.from_numpy(params), torch.from_numpy(x)).numpy()
    assert np.abs(Wa - Wb).max() < 1e-12
    J, O, I, P = tra.bilinear_nonzeros(b, b)
    q = np.zeros((5, b.size()))
    np.add.at(q.T, O, (params[P] * x[:, J] * x[:, I]).T)
    assert np.abs(q - np.einsum("boi,bi->bo", Wa, x)).max() < 1e-12


def test_canonical_ties_break_by_repr():
    """Reps of one group and one size (V⊗V* against V⊗V of SL(2)) sort by
    ``repr`` in the port, the same in every process."""
    G = tG.SL(2)
    a, b = tra.T(1, 1, G=G), tra.T(2, 0, G=G)
    assert (a < b) == (repr(a) < repr(b)) and (b < a) == (repr(b) < repr(a))
    assert repr(tra.SumRep(a, b)) == repr(tra.SumRep(b, a))
