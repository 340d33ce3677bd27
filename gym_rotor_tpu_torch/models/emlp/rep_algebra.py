"""General representation algebra: ⊕ / ⊗ / dual / ``>>`` over arbitrary
groups, with canonicalization, permutation bookkeeping and a solution cache
(own copy of ``gym_rotor_tpu/models/emlp/rep_algebra.py``).

This is the *general* engine behind the scoped one in ``reps.py``: the
flagship's networks only need sums of single-group tensor atoms, but the
algebra lets users type arbitrary representations and solve their
equivariant bases: ``Rep``, ``ScalarRep``, ``Base``, ``Dual``, ``T(p, q)``,
``SumRep`` with its canonical permutation, ``ProductRep`` and
``DirectProduct``, the deferred variants, ``constraint_matrix`` /
``constraint_ops``, the cached ``equivariant_basis``,
``equivariant_projector`` and ``bilinear_weights``.

Every ``rho``/``drho``/basis is a dense host-side NumPy array, solved once
and turned into constant tensors by the layers (``general_nn.py``).  The
canonical layouts, the dense (SVD) bases and the bilinear layer's sampled
indices are bit for bit the JAX package's:

* the small-rep solver is dense SVD (``orthogonal_complement``);
  constraint matrices past ``MAX_DENSE_ENTRIES`` go to the matrix-free
  iterative solve (``iterative_constraint_solve``) with the constraint
  applied blockwise, Kronecker-structured for ``ProductRep``, so the dense
  C is never materialised.  Its momentum-SGD loop runs as a torch loop on
  the host from the same seeded ``W0``, in the same chunks of
  ``ITER_CHUNK`` steps with the same learning-rate schedule and stopping
  rule; its bits differ from XLA's, the subspace it finds does not;
* canonical ordering sorts groups by ``repr`` (deterministic, where
  Python's salted ``hash`` is not);
* ``ScalarRep.__call__(G)``/``Base.__call__(G)`` return new objects;
* ``bilinear_weights``'s reduced-index subsampling draws from
  ``np.random.default_rng(0)``.
"""
from __future__ import annotations

import itertools
from functools import lru_cache, reduce
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.linalg import expm

from .groups import Group

NULLSPACE_TOL = 1e-5       # reps/utils.py:90
MAX_DENSE_ENTRIES = 3e7    # representation.py:113 — beyond this, go iterative

# Module-level solution cache, keyed by canonicalized rep
# (representation.py:99 ``Rep.solcache``).
solcache: Dict["Rep", np.ndarray] = {}


def orthogonal_complement(C: np.ndarray) -> np.ndarray:
    """Orthonormal null-space basis of C (reps/utils.py:87-91): right
    singular vectors with sigma <= tol, shape (n, r)."""
    if C.shape[0] == 0:
        return np.eye(C.shape[1])
    _, S, VH = np.linalg.svd(C, full_matrices=True)
    rank = int((S > NULLSPACE_TOL).sum())
    return VH[rank:].conj().T


class ConvergenceError(Exception):
    """Iterative constraint solve failed to converge (reps/utils.py:173)."""


def iterative_constraint_solve(rep: "Rep", tol: float = NULLSPACE_TOL,
                               seed: int = 0) -> np.ndarray:
    """Matrix-free null-space solve for constraint matrices too large to
    densify: momentum-SGD on ‖CW‖²/2 with iterative rank doubling, the
    reference's ``krylov_constraint_solve`` (reps/utils.py:94-109).  C is
    never materialized — each constraint block is applied through
    ``rep.constraint_ops()`` (Kronecker-structured for ProductRep)."""
    n = rep.size()
    r = 5
    if n * r * 2 > 2e9:  # reps/utils.py:98
        raise RuntimeError(
            f"Solns for constraints on rep of size {n} too large to fit "
            "in memory")
    found_rank = 5
    Q = None
    while found_rank == r:
        r *= 2  # iterative doubling until the full solution space fits
        if n * r > 2e9:  # reps/utils.py:103-106
            import logging
            logging.error("Hit memory limits, switching to sample "
                          "equivariant subspace of size %r", found_rank)
            break
        Q = _iterative_solve_upto_r(rep, r, tol, seed=seed)
        found_rank = Q.shape[-1]
    return Q


ITER_CHUNK = 250   # SGD steps between two looks at the loss


def _iterative_solve_upto_r(rep: "Rep", r: int, tol: float,
                            lr: float = 1e-2, seed: int = 0) -> np.ndarray:
    """Solve CQ=0, QᴴQ=I up to rank r (the reference's
    ``krylov_constraint_solve_upto_r``): momentum-SGD on ½Σ‖BW‖² with the
    analytic gradient ΣBᴴ(BW), as a torch loop on the host in float64 (or
    complex128 for complex constraints) from a seeded ``W0``; the loss is
    read every ``ITER_CHUNK`` steps."""
    ops = rep.constraint_ops()
    n = rep.size()
    rng = np.random.default_rng((seed, r))
    # Probe one block to learn the constraint dtype (U/SU are complex).
    probe = ops[0][0](np.ones((n, 1)))
    W = rng.standard_normal((n, r)) / np.sqrt(n)
    if np.iscomplexobj(probe):
        W = W + 1j * rng.standard_normal((n, r)) / np.sqrt(n)

    def loss_grad(W, with_loss):
        """(½Σ‖BW‖² where ``with_loss``, else None; ΣBᴴ(BW))."""
        L = 0.0 if with_loss else None
        g = None
        for apply_, applyH in ops:
            BW = apply_(W)
            if with_loss:
                L = L + 0.5 * torch.sum(torch.abs(BW) ** 2)
            gi = applyH(BW)
            g = gi if g is None else g + gi
        return L, g

    with torch.no_grad():
        W = torch.from_numpy(W)
        V = torch.zeros_like(W)
        converged = False
        for it in range(0, 20000, ITER_CHUNK):
            # the loss of a chunk's last step is the only one read
            for step in range(ITER_CHUNK):
                L, g = loss_grad(W, step == ITER_CHUNK - 1)
                V = 0.9 * V + g          # torch.optim.SGD(momentum=.9)
                W = W - lr * V
            Lval = float(L)
            if np.sqrt(Lval) < tol:
                converged = True
                break
            if Lval > 2e3 and it > 100:  # diverged: lower lr
                if lr < 1e-4:
                    raise ConvergenceError(
                        f"Failed to converge even with smaller learning "
                        f"rate {lr:.2e}")
                return _iterative_solve_upto_r(rep, r, tol, lr=lr / 3,
                                               seed=seed)
        if not converged:
            raise ConvergenceError("Failed to converge.")

    W = W.numpy()
    # Orthogonalize the converged solution.
    U, S, _ = np.linalg.svd(W, full_matrices=False)
    rank = int((S > 10 * tol).sum())
    Q = U[:, :rank]
    final_L = sum(0.5 * np.sum(np.abs(np.asarray(a(Q))) ** 2)
                  for a, _ in ops)
    if final_L > tol:
        import logging
        logging.warning("Normalized basis has too high error %.2e for "
                        "tol %.2e", final_L, tol)
    scutoff = S[rank] if r > rank else 0
    assert rank == 0 or scutoff < S[rank - 1] / 100, (
        f"Singular value gap too small: {S[rank - 1]:.2e} above cutoff "
        f"{scutoff:.2e} below cutoff. Final L {final_L:.2e}")
    return Q


_TENSOR_OF: Dict[tuple, tuple] = {}


def _on(M: np.ndarray, X):
    """Host matrix ``M`` in the array type of ``X``: itself for a NumPy
    ``X``, else a tensor on ``X``'s device in the dtype ``M`` and ``X``
    promote to (made once per matrix, dtype and device)."""
    if isinstance(X, np.ndarray):
        return M
    dtype = torch.promote_types(torch.from_numpy(np.zeros(0, M.dtype)).dtype,
                                X.dtype)
    key = (id(M), dtype, str(X.device))
    hit = _TENSOR_OF.get(key)
    if hit is None:
        # keep ``M`` alive so its id cannot be reused by another array
        hit = _TENSOR_OF[key] = (torch.as_tensor(M).to(X.device, dtype), M)
    return hit[0]


def _rows(X, idx: np.ndarray):
    """``X[idx]`` for a NumPy or torch ``X`` (a torch index made once per
    index array and device)."""
    if isinstance(X, np.ndarray):
        return X[idx]
    key = (id(idx), "rows", str(X.device))
    hit = _TENSOR_OF.get(key)
    if hit is None:
        hit = _TENSOR_OF[key] = (torch.as_tensor(idx, device=X.device), idx)
    return X[hit[0]]


def _mm(M: np.ndarray, X):
    """``M @ X`` for a NumPy or torch ``X``."""
    Mx = _on(M, X)
    if isinstance(X, torch.Tensor) and X.dtype != Mx.dtype:
        X = X.to(Mx.dtype)
    return Mx @ X


def _as_matrix(M, G: Optional[Group]):
    """Resolve a group element that may be given as {Group: matrix}."""
    if isinstance(M, dict):
        return M[G]
    return M


class Rep:
    """Base representation: formalizes (V, rho, drho) as one immutable
    object (representation.py:18-26).  Subclasses implement ``rho`` (dense),
    ``size``, ``__repr__``, ``__hash__``/``__eq__``."""

    is_permutation = False
    G: Optional[Group] = None

    # -- core maps ---------------------------------------------------------
    def rho(self, M) -> np.ndarray:
        raise NotImplementedError

    def drho(self, A) -> np.ndarray:
        """Lie-algebra rep.  Default: numerical JVP of rho at the identity
        (the reference uses autodiff ``LazyJVP``, representation.py:38-41);
        concrete subclasses all override with exact formulas."""
        A = _as_matrix(A, self.G)
        d = A.shape[0]
        t = 1e-6
        rp = self.rho(expm(t * A))
        rm = self.rho(expm(-t * A))
        return (rp - rm) / (2 * t)

    def size(self) -> int:
        raise NotImplementedError

    def concrete(self) -> bool:
        return isinstance(self.G, Group)

    def __call__(self, G: Optional[Group]) -> "Rep":
        """Instantiate a (possibly deferred) rep with a symmetry group."""
        raise NotImplementedError

    # -- canonicalization --------------------------------------------------
    def canonicalize(self) -> Tuple["Rep", np.ndarray]:
        """(canonical rep, perm) with ``v[perm]`` in canonical order
        (representation.py:70-77)."""
        return self, np.arange(self.size())

    # -- solver ------------------------------------------------------------
    def constraint_matrix(self) -> np.ndarray:
        """Dense equivariance constraint: rows (rho(h)-I) for each discrete
        generator and drho(A) for each Lie-algebra basis element
        (representation.py:87-97)."""
        n = self.size()
        G = self.G
        rows = [self.rho(h) - np.eye(n) for h in G.discrete_generators]
        rows += [self.drho(A) for A in G.lie_algebra]
        if not rows:
            return np.zeros((1, n))
        return np.concatenate([np.asarray(r) for r in rows], axis=0)

    def constraint_ops(self):
        """Blockwise constraint application: a list of ``(apply, applyH)``
        pairs, one per generator, such that stacking ``apply`` over blocks
        equals ``constraint_matrix() @ ·`` — the matrix-free form consumed
        by ``iterative_constraint_solve``.  Default densifies each block
        (n x n per generator, never the stacked C); ProductRep overrides
        with Kronecker-structured applies."""
        ops = []
        for h in self.G.discrete_generators:
            R = np.asarray(self.rho(h))
            RH = R.conj().T
            ops.append((lambda X, R=R: _mm(R, X) - X,
                        lambda Y, RH=RH: _mm(RH, Y) - Y))
        for A in self.G.lie_algebra:
            D = np.asarray(self.drho(A))
            DH = D.conj().T
            ops.append((lambda X, D=D: _mm(D, X),
                        lambda Y, DH=DH: _mm(DH, Y)))
        return ops

    def _constraint_entries(self) -> int:
        """Dense size of ``constraint_matrix()`` without building it."""
        n = self.size()
        n_gen = len(self.G.discrete_generators) + len(self.G.lie_algebra)
        return n_gen * n * n

    def equivariant_basis(self) -> np.ndarray:
        """Invariant-subspace basis Q (N, r), canonicalized + cached
        (representation.py:101-119).  Small constraints solve densely;
        past MAX_DENSE_ENTRIES the matrix-free iterative solver takes over
        (representation.py:113-114)."""
        if self == Scalar:
            return np.ones((1, 1))
        canon_rep, perm = self.canonicalize()
        invperm = np.argsort(perm)
        if canon_rep not in solcache:
            if canon_rep._constraint_entries() > MAX_DENSE_ENTRIES:
                solcache[canon_rep] = iterative_constraint_solve(canon_rep)
            else:
                solcache[canon_rep] = orthogonal_complement(
                    canon_rep.constraint_matrix())
        return solcache[canon_rep][invperm]

    def equivariant_projector(self) -> np.ndarray:
        """P = Q Q^H (representation.py:121-126), dense."""
        Q = self.equivariant_basis()
        return Q @ Q.conj().T

    # -- algebra -----------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, int):
            if other == 0:
                return self
            return self + other * Scalar
        if both_concrete(self, other):
            return SumRep(self, other)
        return DeferredSumRep(self, other)

    def __radd__(self, other):
        if isinstance(other, int):
            if other == 0:
                return self
            return other * Scalar + self
        return NotImplemented

    def __mul__(self, other):
        return mul_reps(self, other)

    def __rmul__(self, other):
        return mul_reps(other, self)

    def __pow__(self, n: int):
        assert isinstance(n, int) and n >= 0, f"unsupported power {n}"
        return reduce(lambda a, b: a * b, n * [self], Scalar)

    def __rshift__(self, other):
        """Linear maps self -> other: other ⊗ self* (representation.py:163)."""
        return other * self.t()

    def __lshift__(self, other):
        """Linear maps other -> self."""
        return self * other.t()

    def t(self) -> "Rep":
        """Dual V*; orthogonal groups are self-dual (representation.py:189-193)."""
        if isinstance(self.G, Group) and self.G.is_orthogonal:
            return self
        return Dual(self)

    def __lt__(self, other):
        """Canonical ordering: Group, then size, then ``repr``, then hash
        (the reference's ``representation.py:171-187`` goes from size to
        hash; ``repr`` first keeps ties such as V⊗V* against V⊗V of a
        non-orthogonal group in one order in every process)."""
        if other == Scalar:
            return False
        if self == Scalar:
            return True
        try:
            if self.G < other.G:
                return True
            if other.G < self.G:
                return False
        except (AttributeError, TypeError):
            pass
        if self.size() < other.size():
            return True
        if self.size() > other.size():
            return False
        if repr(self) != repr(other):
            return repr(self) < repr(other)
        return hash(self) < hash(other)

    def __eq__(self, other):
        return type(self) is type(other) and hash(self) == hash(other)

    def __hash__(self):
        raise NotImplementedError

    def __repr__(self):
        raise NotImplementedError


def both_concrete(*reps) -> bool:
    return all(r.concrete() for r in reps)


def _common_group(reps) -> Optional[Group]:
    """The single group shared by all (non-scalar) constituents, else None."""
    Gs = {r.G for r in reps if r.G is not None}
    return next(iter(Gs)) if len(Gs) == 1 else None


def groups_of(rep: "Rep") -> List[Group]:
    """All distinct groups a (possibly cross-group) rep acts under — one for
    plain reps, several for DirectProduct factors.  Used by
    ``diagnostics.equivariance_error`` to sample one element per group."""
    if isinstance(rep, SumRep):
        out: List[Group] = []
        for r in rep.reps:
            for g in groups_of(r):
                if all(g != h for h in out):
                    out.append(g)
        return out
    if isinstance(rep, DirectProduct):
        return [r.G for r in rep.reps]
    return [rep.G] if rep.G is not None else []


# ----------------------------------------------------------------------------
# Atomic reps
# ----------------------------------------------------------------------------
class ScalarRep(Rep):
    """Trivial rep V^0 (representation.py:214-260)."""

    is_permutation = True

    def __init__(self, G: Optional[Group] = None):
        self.G = G

    def __call__(self, G):
        return ScalarRep(G)

    def size(self):
        return 1

    def canonicalize(self):
        return self, np.zeros(1, dtype=np.int64)

    def rho(self, M):
        return np.eye(1)

    def drho(self, A):
        return np.zeros((1, 1))

    def t(self):
        return self

    def concrete(self):
        return True

    def __mul__(self, other):
        if isinstance(other, int):
            return super().__mul__(other)
        return other

    def __rmul__(self, other):
        if isinstance(other, int):
            return super().__rmul__(other)
        return other

    def __hash__(self):
        return 0

    def __eq__(self, other):
        return isinstance(other, ScalarRep)

    def __repr__(self):
        return "V0"


class Base(Rep):
    """Base rep V of a group: rho(g) = g (representation.py:263-301)."""

    def __init__(self, G: Optional[Group] = None):
        self.G = G
        if G is not None:
            self.is_permutation = G.is_permutation

    def __call__(self, G):
        return self if G is None else type(self)(G)

    def rho(self, M):
        return np.asarray(_as_matrix(M, self.G))

    def drho(self, A):
        return np.asarray(_as_matrix(A, self.G))

    def size(self):
        assert self.G is not None, f"need G for size of {self}"
        return self.G.d

    def __hash__(self):
        return hash((type(self), self.G))

    def __eq__(self, other):
        return type(other) is type(self) and self.G == other.G

    def __lt__(self, other):
        if isinstance(other, Dual):
            return True
        return super().__lt__(other)

    def __repr__(self):
        return "V"


class Dual(Rep):
    """Dual rep V*: rho*(g) = rho(g)^{-T}, drho*(A) = -drho(A)^T
    (representation.py:304-343)."""

    def __init__(self, rep: Rep):
        self.rep = rep
        self.G = rep.G
        self.is_permutation = rep.is_permutation

    def __call__(self, G):
        return self.rep(G).t()

    def rho(self, M):
        return np.linalg.inv(self.rep.rho(M)).T

    def drho(self, A):
        return -self.rep.drho(A).T

    def t(self):
        return self.rep

    def size(self):
        return self.rep.size()

    def __hash__(self):
        return hash((type(self), self.rep))

    def __eq__(self, other):
        return type(other) is type(self) and self.rep == other.rep

    def __lt__(self, other):
        if other == self.rep:
            return False
        return super().__lt__(other)

    def __repr__(self):
        return repr(self.rep) + "*"


#: The deferred base vector rep (bind with ``V(G)``), representation.py:347.
V = Vector = Base()

#: The scalar rep singleton, representation.py:350.
Scalar = ScalarRep()


def T(p: int, q: int = 0, G: Optional[Group] = None) -> Rep:
    """Rank-(p,q) tensor constructor: V^⊗p ⊗ (V*)^⊗q
    (representation.py:353-355)."""
    return (V ** p * V.t() ** q)(G)


# ----------------------------------------------------------------------------
# mul dispatch (representation.py:196-211, 554-573)
# ----------------------------------------------------------------------------
def mul_reps(ra, rb):
    if isinstance(rb, int):
        if rb == 1:
            return ra
        if rb == 0:
            return 0
        if ra.concrete():
            return SumRep(*(rb * [ra]))
        return DeferredSumRep(*(rb * [ra]))
    if isinstance(ra, int):
        return mul_reps(rb, ra)
    if isinstance(ra, ScalarRep):
        return rb
    if isinstance(rb, ScalarRep):
        return ra
    if isinstance(ra, SumRep) or isinstance(rb, SumRep):
        if not both_concrete(ra, rb):
            return DeferredProductRep(ra, rb)
        return distribute_product([ra, rb])
    if not both_concrete(ra, rb):
        return DeferredProductRep(ra, rb)
    if isinstance(ra.G, Group) and isinstance(rb.G, Group) and ra.G == rb.G:
        return ProductRep(ra, rb)
    return DirectProduct(ra, rb)


# ----------------------------------------------------------------------------
# SumRep: direct sums with canonicalization + perm bookkeeping
# ----------------------------------------------------------------------------
def _block_diag(blocks: Sequence[np.ndarray]) -> np.ndarray:
    n = sum(b.shape[0] for b in blocks)
    m = sum(b.shape[1] for b in blocks)
    dtype = np.result_type(*[b.dtype for b in blocks]) if blocks else np.float64
    out = np.zeros((n, m), dtype)
    i = j = 0
    for b in blocks:
        out[i:i + b.shape[0], j:j + b.shape[1]] = b
        i += b.shape[0]
        j += b.shape[1]
    return out


class SumRep(Rep):
    """Direct sum ⊕ with canonical grouping-by-type and the permutation
    back to the user's coordinate order (representation.py:405-546).

    ``self.reps`` is {rep: multiplicity} in canonical (sorted) order;
    ``self.perm`` satisfies: v[perm] is in canonical block order."""

    def __init__(self, *reps, extra_perm: Optional[np.ndarray] = None):
        reps = [SumRep.from_counter({Scalar: r}) if isinstance(r, int)
                else r for r in reps]
        canon = [r.canonicalize() for r in reps]
        counters = [r.reps if isinstance(r, SumRep) else {r: 1}
                    for r, _ in canon]
        perms = [p for _, p in canon]
        self.reps, perm = self.compute_canonical(counters, perms)
        self.perm = perm if extra_perm is None else np.asarray(extra_perm)[perm]
        self.invperm = np.argsort(self.perm)
        self.canonical = bool((self.perm == np.arange(len(self.perm))).all())
        self.is_permutation = all(r.is_permutation for r in self.reps)
        self.G = _common_group(self.reps)

    @classmethod
    def from_counter(cls, counter: Dict[Rep, int],
                     perm: Optional[np.ndarray] = None) -> "SumRep":
        """SumRepFromCollection (representation.py:576-585)."""
        obj = cls.__new__(cls)
        size = sum(r.size() * c for r, c in counter.items())
        p = np.arange(size) if perm is None else np.asarray(perm)
        obj.reps, obj.perm = cls.compute_canonical([counter], [p])
        obj.invperm = np.argsort(obj.perm)
        obj.canonical = bool((obj.perm == np.arange(len(obj.perm))).all())
        obj.is_permutation = all(r.is_permutation for r in obj.reps)
        obj.G = _common_group(obj.reps)
        return obj

    @staticmethod
    def compute_canonical(counters: List[Dict[Rep, int]],
                          perms: List[np.ndarray]
                          ) -> Tuple[Dict[Rep, int], np.ndarray]:
        """Merge canonicalized summand counters; concatenate each unique
        rep's coordinate chunks across summands in sorted-rep order
        (representation.py:507-530)."""
        unique = sorted(reduce(lambda a, b: a | b,
                               [set(c.keys()) for c in counters]))
        shifted = []
        n = 0
        for p in perms:
            shifted.append(n + np.asarray(p))
            n += len(p)
        merged: Dict[Rep, int] = {}
        chunks = []
        ids = [0] * len(counters)
        for rep in unique:
            for i, (cnt, sp) in enumerate(zip(counters, shifted)):
                c = cnt.get(rep, 0)
                chunks.append(sp[ids[i]:ids[i] + c * rep.size()])
                ids[i] += c * rep.size()
                merged[rep] = merged.get(rep, 0) + c
        merged = {r: c for r, c in merged.items() if c}
        return merged, np.concatenate(chunks) if chunks else np.zeros(0, np.int64)

    def size(self):
        return sum(r.size() * c for r, c in self.reps.items())

    def canonicalize(self):
        return SumRep.from_counter(self.reps), self.perm

    def __call__(self, G):
        return SumRep.from_counter({r(G): c for r, c in self.reps.items()},
                                   perm=self.perm)

    def concrete(self):
        return True

    def rho(self, M):
        blocks = [r.rho(M) for r, c in self.reps.items() for _ in range(c)]
        D = _block_diag(blocks)
        return D[self.invperm][:, self.invperm]

    def drho(self, A):
        blocks = [r.drho(A) for r, c in self.reps.items() for _ in range(c)]
        D = _block_diag(blocks)
        return D[self.invperm][:, self.invperm]

    def t(self):
        """Swap each summand to its dual, keeping elements in place
        (representation.py:446-449)."""
        return SumRep(*[r.t() for r, c in self.reps.items()
                        for _ in range(c)], extra_perm=self.perm)

    def equivariant_basis(self):
        """Blockwise: solve per unique rep, tile by multiplicity, reorder
        rows back to user coordinates (representation.py:466-479)."""
        Qs = {r: r.equivariant_basis() for r in self.reps}
        blocks = [Qs[r] for r, c in self.reps.items() for _ in range(c)]
        return _block_diag(blocks)[self.invperm]

    def as_dict(self, v: np.ndarray) -> Dict[Rep, np.ndarray]:
        """Split a vector (…, size) into {rep: (…, mult, rep.size())} chunks
        in canonical order (representation.py:538-546)."""
        out = {}
        i = 0
        for rep, c in self.reps.items():
            chunk = c * rep.size()
            out[rep] = v[..., self.perm[i:i + chunk]].reshape(
                v.shape[:-1] + (c, rep.size()))
            i += chunk
        return out

    def __iter__(self):
        return (r for r, c in self.reps.items() for _ in range(c))

    def __len__(self):
        return sum(self.reps.values())

    def __eq__(self, other):
        return (isinstance(other, SumRep)
                and self.reps == other.reps
                and len(self.perm) == len(other.perm)
                and bool((self.perm == other.perm).all()))

    def __hash__(self):
        return hash(tuple(self.reps.items()))

    def __repr__(self):
        return "+".join(f"{c if c > 1 else ''}{r!r}"
                        for r, c in self.reps.items())


# ----------------------------------------------------------------------------
# Products
# ----------------------------------------------------------------------------
def _kron_all(mats: Sequence[np.ndarray]) -> np.ndarray:
    return reduce(np.kron, mats, np.eye(1))


def _kronsum_all(mats: Sequence[np.ndarray]) -> np.ndarray:
    """⊕-sum over slots: sum_i I ⊗ … ⊗ A_i ⊗ … ⊗ I."""
    out = np.zeros((int(np.prod([m.shape[0] for m in mats])),) * 2,
                   dtype=np.result_type(*[m.dtype for m in mats]))
    for i, Ai in enumerate(mats):
        term = _kron_all([Ai if j == i else np.eye(m.shape[0])
                          for j, m in enumerate(mats)])
        out = out + term
    return out


def _kron_apply(mats: Sequence[np.ndarray], X):
    """kron(mats) @ X for X of shape (prod d_i, r) (NumPy or torch) without
    materializing the Kronecker product: contract each factor along its
    own axis."""
    r = X.shape[-1]
    dims = tuple(m.shape[1] for m in mats)
    T = X.reshape(dims + (r,))
    for i, M in enumerate(mats):
        T = _moveaxis(_contract(M, T, i), 0, i)
    return T.reshape(-1, r)


def _kronsum_apply(mats: Sequence[np.ndarray], X):
    """(sum_i I⊗…⊗A_i⊗…⊗I) @ X, matrix-free."""
    r = X.shape[-1]
    dims = tuple(m.shape[1] for m in mats)
    T = X.reshape(dims + (r,))
    out = None
    for i, M in enumerate(mats):
        term = _moveaxis(_contract(M, T, i), 0, i)
        out = term if out is None else out + term
    return out.reshape(-1, r)


def _kron_perm(mats: Sequence[np.ndarray]) -> Optional[np.ndarray]:
    """If every matrix is a permutation matrix (one 1 a row, zeros
    elsewhere), the index ``k`` with ``kron(mats) @ X == X[k]``; else
    None."""
    cols = []
    for M in mats:
        if np.iscomplexobj(M) or not (
                np.isin(M, (0.0, 1.0)).all() and (M.sum(1) == 1).all()
                and (M.sum(0) == 1).all()):
            return None
        cols.append(np.argmax(M, axis=1))
    k = np.zeros(1, np.int64)
    for c, M in zip(cols, mats):
        k = (k[:, None] * M.shape[1] + c[None, :]).reshape(-1)
    return k


def _contract(M: np.ndarray, T, i: int):
    """``tensordot(M, T, axes=((1,), (i,)))`` for a NumPy or torch ``T``."""
    if isinstance(T, np.ndarray):
        return np.tensordot(M, T, axes=((1,), (i,)))
    Mx = _on(M, T)
    if T.dtype != Mx.dtype:
        T = T.to(Mx.dtype)
    return torch.tensordot(Mx, T, dims=([1], [i]))


def _moveaxis(T, a: int, b: int):
    return (np.moveaxis(T, a, b) if isinstance(T, np.ndarray)
            else torch.movedim(T, a, b))


class ProductRep(Rep):
    """Same-group tensor product ⊗ with canonical slot ordering
    (representation.py:655-761).  ``self.reps`` = {rep: power} sorted;
    ``self.perm`` maps canonical tensor layout -> user layout."""

    def __init__(self, *reps, extra_perm=None,
                 counter: Optional[Dict[Rep, int]] = None):
        if counter is not None:
            self.reps = counter
            size = int(np.prod([r.size() ** c for r, c in counter.items()]))
            base = np.arange(size) if extra_perm is None else np.asarray(extra_perm)
            self.reps, self.perm = self.compute_canonical([counter], [base])
        else:
            canon = [r.canonicalize() for r in reps]
            counters = [r.reps if isinstance(r, ProductRep) else {r: 1}
                        for r, _ in canon]
            perms = [p for _, p in canon]
            self.reps, perm = self.compute_canonical(counters, perms)
            self.perm = perm if extra_perm is None else np.asarray(extra_perm)[perm]
        self.invperm = np.argsort(self.perm)
        self.canonical = bool((self.perm == self.invperm).all())
        Gs = tuple(set(r.G for r in self.reps))
        assert len(Gs) == 1, f"multiple groups {Gs} in ProductRep"
        self.G = Gs[0]
        self.is_permutation = all(r.is_permutation for r in self.reps)

    @staticmethod
    def compute_canonical(counters: List[Dict[Rep, int]],
                          perms: List[np.ndarray]
                          ) -> Tuple[Dict[Rep, int], np.ndarray]:
        """Sort tensor slots by rep type; track the index permutation by
        moving axes of the order tensor (representation.py:724-761)."""
        order = np.arange(int(np.prod([len(p) for p in perms])))
        unique = sorted(reduce(lambda a, b: a | b,
                               [set(c.keys()) for c in counters]))
        # canonicalize within each factor axis
        order = order.reshape(tuple(len(p) for p in perms))
        for i, p in enumerate(perms):
            order = np.moveaxis(np.moveaxis(order, i, 0)[np.asarray(p), ...],
                                0, i)
        # assign slot-axis ids per (factor, rep)
        axis_ids = []
        n = 0
        for cnt in counters:
            ids = {}
            for rep, c in cnt.items():
                ids[rep] = n + np.arange(c)
                n += c
            axis_ids.append(ids)
        merged: Dict[Rep, int] = {}
        axes_perm = []
        for rep in unique:
            for i, cnt in enumerate(counters):
                c = cnt.get(rep, 0)
                if c:
                    axes_perm.append(axis_ids[i][rep])
                    merged[rep] = merged.get(rep, 0) + c
        axes_perm = np.concatenate(axes_perm)
        order = order.reshape(tuple(r.size() for cnt in counters
                                    for r, c in cnt.items() for _ in range(c)))
        final = np.transpose(order, tuple(int(a) for a in axes_perm))
        return merged, final.reshape(-1)

    def size(self):
        return int(np.prod([r.size() ** c for r, c in self.reps.items()]))

    def canonicalize(self):
        return type(self)(counter=self.reps), self.perm

    def __call__(self, G):
        return reduce(lambda a, b: a * b,
                      [r(G) for r, c in self.reps.items() for _ in range(c)])

    def concrete(self):
        return True

    def rho(self, M):
        M = _as_matrix(M, self.G)
        K = _kron_all([r.rho(M) for r, c in self.reps.items()
                       for _ in range(c)])
        return K[self.invperm][:, self.invperm]

    def drho(self, A):
        A = _as_matrix(A, self.G)
        K = _kronsum_all([r.drho(A) for r, c in self.reps.items()
                          for _ in range(c)])
        return K[self.invperm][:, self.invperm]

    def constraint_ops(self):
        """Kronecker-structured constraint applies: rho is kron(factors)
        conjugated by ``perm``, so ``rho @ X == kron_apply(X[perm])[invperm]``
        and the factors (each only d_i x d_i) are all that is ever
        densified.  This is what makes the iterative fallback matrix-free
        for the tensor-power reps whose constraints blow MAX_DENSE_ENTRIES
        (the reference reaches the same effect with LazyKron operators,
        representation.py:700-723).  A discrete generator whose factors are
        all permutation matrices is a permutation of the coordinates: its
        apply is one gather (``_kron_perm``), the same numbers."""
        factors = [r for r, c in self.reps.items() for _ in range(c)]
        perm, invperm = self.perm, self.invperm
        ops = []
        for h in self.G.discrete_generators:
            mats = [np.asarray(r.rho(h)) for r in factors]
            kidx = _kron_perm(mats)
            if kidx is not None:
                fwd = perm[kidx[invperm]]
                adj = perm[np.argsort(kidx)[invperm]]
                ops.append((lambda X, fwd=fwd: _rows(X, fwd) - X,
                            lambda Y, adj=adj: _rows(Y, adj) - Y))
                continue
            matsH = [m.conj().T for m in mats]
            ops.append((
                lambda X, mats=mats: _rows(_kron_apply(mats, _rows(X, perm)),
                                           invperm) - X,
                lambda Y, matsH=matsH: _rows(
                    _kron_apply(matsH, _rows(Y, perm)), invperm) - Y))
        for A in self.G.lie_algebra:
            dmats = [np.asarray(r.drho(A)) for r in factors]
            dmatsH = [m.conj().T for m in dmats]
            ops.append((
                lambda X, dmats=dmats: _rows(
                    _kronsum_apply(dmats, _rows(X, perm)), invperm),
                lambda Y, dmatsH=dmatsH: _rows(
                    _kronsum_apply(dmatsH, _rows(Y, perm)), invperm)))
        return ops

    def t(self):
        return type(self)(*[r.t() for r, c in self.reps.items()
                            for _ in range(c)], extra_perm=self.perm)

    def __eq__(self, other):
        return (isinstance(other, type(self)) and self.reps == other.reps
                and len(self.perm) == len(other.perm)
                and bool((self.perm == other.perm).all()))

    def __hash__(self):
        assert self.canonical, f"hashing non-canonical {self!r}"
        return hash(tuple(self.reps.items()))

    def __repr__(self):
        return "⊗".join(f"{r!r}{c if c > 1 else ''}"
                        for r, c in self.reps.items())


class DirectProduct(ProductRep):
    """Cross-group tensor product: a rep of G1 x G2, whose solution factors
    as Q = Q1 ⊗ Q2 (representation.py:764-824)."""

    def __init__(self, *reps, counter=None, extra_perm=None):
        if counter is not None:
            self.reps = counter
            size = int(np.prod([r.size() ** c for r, c in counter.items()]))
            self.reps, perm = self.compute_canonical(
                [counter], [np.arange(size)])
            self.perm = perm if extra_perm is None else np.asarray(extra_perm)[perm]
        else:
            canon = [r.canonicalize() for r in reps]
            counters = [r.reps if isinstance(r, DirectProduct) else {r: 1}
                        for r, _ in canon]
            perms = [p for _, p in canon]
            merged, perm = self.compute_canonical(counters, perms)
            # regroup the sorted slots into one sub-product per group
            group_prod: Dict[Group, Rep] = {}
            for rep, c in merged.items():
                group_prod[rep.G] = group_prod.get(rep.G, 1) * rep ** c
            sub = {rep: 1 for rep in group_prod.values()}
            self.reps = sub
            self.reps, perm2 = self.compute_canonical(
                [sub], [np.arange(int(np.prod([r.size() for r in sub])))])
            composed = perm[perm2]
            self.perm = (composed if extra_perm is None
                         else np.asarray(extra_perm)[composed])
        self.invperm = np.argsort(self.perm)
        self.canonical = bool((self.perm == self.invperm).all())
        self.is_permutation = all(r.is_permutation for r in self.reps)
        self.G = None
        assert all(c == 1 for c in self.reps.values())

    def size(self):
        return int(np.prod([r.size() for r in self.reps]))

    def __call__(self, G):
        raise TypeError("DirectProduct is already bound to its groups")

    def rho(self, Ms):
        K = _kron_all([r.rho(Ms) for r in self.reps])
        return K[self.invperm][:, self.invperm]

    def drho(self, As):
        K = _kronsum_all([r.drho(As) for r in self.reps])
        return K[self.invperm][:, self.invperm]

    def equivariant_basis(self):
        Q = _kron_all([r.equivariant_basis() for r in self.reps])
        return Q[self.invperm]

    def equivariant_projector(self):
        P = _kron_all([r.equivariant_projector() for r in self.reps])
        return P[self.invperm][:, self.invperm]

    def __repr__(self):
        return "⊗".join(f"{r!r}_{r.G}" for r in self.reps)


# ----------------------------------------------------------------------------
# Products of sums: distribute ⊗ over ⊕ (representation.py:588-652)
# ----------------------------------------------------------------------------
@lru_cache(maxsize=None)
def _rep_permutation(repsizes_all: Tuple[Tuple[int, ...], ...]) -> np.ndarray:
    """Permutation from block ordering to flattened tensor-product ordering
    (representation.py:635-652)."""
    cumsums = [list(itertools.accumulate([0] + list(sizes)))
               for sizes in repsizes_all]
    shape = [cs[-1] for cs in cumsums]
    perm = np.zeros(shape, dtype=np.int64)
    arange = np.arange(int(np.prod(shape)))
    i = 0
    for idx in itertools.product(*[range(len(s)) for s in repsizes_all]):
        slices = tuple(slice(cs[k], cs[k + 1]) for k, cs in zip(idx, cumsums))
        lens = [s.stop - s.start for s in slices]
        chunk = int(np.prod(lens))
        perm[slices] += arange[i:i + chunk].reshape(*lens)
        i += chunk
    return np.argsort(perm.reshape(-1))


def distribute_product(reps: List[Rep], extra_perm=None) -> SumRep:
    """(ρ1⊕ρ2)⊗ρ3 = (ρ1⊗ρ3)⊕(ρ2⊗ρ3) with full index bookkeeping
    (representation.py:588-632)."""
    canon = [r.canonicalize() for r in reps]
    perms = [p for _, p in canon]
    reps = [r if isinstance(r, SumRep) else SumRep.from_counter({r: 1})
            for r, _ in canon]

    # permutation to canonical ordering along each tensor axis
    axis_sizes = [len(p) for p in perms]
    order = np.arange(int(np.prod(axis_sizes))).reshape(axis_sizes)
    for i, p in enumerate(perms):
        order = np.moveaxis(np.moveaxis(order, i, 0)[np.asarray(p), ...], 0, i)
    order = order.reshape(-1)

    # blocks (one per combination of summands) -> flat ordering
    repsizes_all = tuple(tuple(c * r.size() for r, c in rep.reps.items())
                         for rep in reps)
    block_perm = _rep_permutation(repsizes_all)

    ordered_reps = []
    each_perm = []
    i = 0
    for prod in itertools.product(*[rep.reps.items() for rep in reps]):
        rs, cs = zip(*prod)
        mult = int(np.prod(cs))
        prod_rep, canonicalizing_perm = (
            mult * reduce(lambda a, b: a * b, rs)).canonicalize()
        ordered_reps.append(prod_rep)
        shape = []
        for r, c in prod:
            shape.extend([c, r.size()])
        axis_perm = np.concatenate([2 * np.arange(len(prod)),
                                    2 * np.arange(len(prod)) + 1])
        mul_perm = np.arange(len(canonicalizing_perm)).reshape(shape).transpose(
            tuple(int(a) for a in axis_perm)).reshape(-1)
        each_perm.append(mul_perm[np.asarray(canonicalizing_perm)] + i)
        i += len(canonicalizing_perm)
    each_perm = np.concatenate(each_perm)
    total_perm = order[block_perm[each_perm]]
    if extra_perm is not None:
        total_perm = np.asarray(extra_perm)[total_perm]
    return SumRep(*ordered_reps, extra_perm=total_perm)


# ----------------------------------------------------------------------------
# Deferred reps (bind the group later; representation.py:827-881)
# ----------------------------------------------------------------------------
class DeferredSumRep(Rep):
    """⊕ of reps whose group is not yet known."""

    def __init__(self, *reps):
        self.to_sum = []
        for r in reps:
            self.to_sum.extend(r.to_sum if isinstance(r, DeferredSumRep)
                               else [r])
        self.G = None

    def __call__(self, G):
        if G is None:
            return self
        return SumRep(*[r(G) for r in self.to_sum])

    def t(self):
        return DeferredSumRep(*[r.t() for r in self.to_sum])

    def concrete(self):
        return False

    def __hash__(self):
        return hash((type(self), tuple(self.to_sum)))

    def __repr__(self):
        return "(" + "+".join(f"{r!r}" for r in self.to_sum) + ")"


class DeferredProductRep(Rep):
    """⊗ of reps whose group is not yet known."""

    def __init__(self, *reps):
        self.to_prod = []
        for r in reps:
            assert not isinstance(r, ProductRep)
            self.to_prod.extend(r.to_prod if isinstance(r, DeferredProductRep)
                                else [r])
        self.G = None

    def __call__(self, G):
        if G is None:
            return self
        return reduce(lambda a, b: a * b, [r(G) for r in self.to_prod])

    def t(self):
        return DeferredProductRep(*[r.t() for r in self.to_prod])

    def concrete(self):
        return False

    def __hash__(self):
        return hash((type(self), tuple(self.to_prod)))

    def __repr__(self):
        return "⊗".join(f"{r!r}" for r in self.to_prod)


# ----------------------------------------------------------------------------
# Bilinear weights (representation.py:358-402)
# ----------------------------------------------------------------------------
def _bilinear_layout(out_rep: Rep, in_rep: Rep):
    """The bilinear layer's static structure: the canonical weight rep's
    multiplicities, the input's non-scalar multiplicities, the sampled
    input coordinates of each type (``np.random.default_rng(0)``, whole
    copies drawn with replacement), the permutation from the canonical
    weight layout to ``(out, in)``, and the parameter count."""
    W_rep, W_perm = (in_rep >> out_rep).canonicalize()
    inv_perm = np.argsort(np.asarray(W_perm))
    x_rep = in_rep
    assert isinstance(W_rep, SumRep) and isinstance(x_rep, SumRep), \
        "bilinear_weights needs SumRep in/out (wrap single reps in sums)"
    W_mult = dict(W_rep.reps)
    x_mult = {r: c for r, c in x_rep.reps.items() if r != Scalar}

    def nelems(nx, rep):
        return min(nx, rep.size())

    active_dims = sum(W_mult.get(r, 0) * nelems(c, r)
                      for r, c in x_mult.items())
    rng = np.random.default_rng(0)
    ids_dict = x_rep.as_dict(np.arange(x_rep.size()))
    # Each ids entry is (mult, rep.size()); subsample nelems whole *copies*
    # (rows), giving n*rep.size() flat coordinates.
    reduced = {r: ids[rng.integers(ids.shape[0],
                                   size=nelems(ids.shape[0], r))].reshape(-1)
               for r, ids in ids_dict.items()}
    ns = {r: nelems(c, r) for r, c in x_mult.items()}
    return W_mult, ns, reduced, inv_perm, active_dims


_LAYOUTS: Dict[tuple, tuple] = {}


def bilinear_layout(out_rep: Rep, in_rep: Rep):
    """``_bilinear_layout``, made once per pair of reps (its
    ``in_rep >> out_rep`` canonicalization is the slow part, and the
    blocks of a network share their gated rep)."""
    key = (out_rep, in_rep)
    hit = _LAYOUTS.get(key)
    if hit is None:
        hit = _LAYOUTS[key] = _bilinear_layout(out_rep, in_rep)
    return hit


def bilinear_weights(out_rep: Rep, in_rep: Rep):
    """Parameter count + projection for the equivariant bilinear layer.

    Returns ``(active_dims, proj)`` where ``proj(params, x)`` maps
    coefficients (active_dims,) and activations (..., in_rep.size()) to a
    weight matrix (..., out_rep.size(), in_rep.size()) built from x's own
    type components (the reference's ``lazy_projection``), with NumPy index
    bookkeeping and torch in the forward."""
    W_mult, ns, reduced, inv_perm, active_dims = bilinear_layout(out_rep,
                                                                 in_rep)
    mat_shape = (out_rep.size(), in_rep.size())

    def proj(params, x):
        bshape = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        bs = x.shape[0]
        i = 0
        Ws = []
        for rep, wm in W_mult.items():
            if rep not in ns:
                Ws.append(x.new_zeros((bs, wm * rep.size())))
                continue
            n = ns[rep]
            bids = torch.as_tensor(reduced[rep], device=x.device)
            bp = params[i:i + wm * n].reshape(wm, n)
            i += wm * n
            elems = bp @ x[..., bids].T.reshape(n, rep.size() * bs)
            Ws.append(elems.reshape(wm * rep.size(), bs).T)
        W = torch.cat(Ws, dim=-1)
        perm = torch.as_tensor(inv_perm, device=x.device)
        return W[..., perm].reshape(*bshape, *mat_shape)

    return active_dims, proj


def bilinear_nonzeros(out_rep: Rep, in_rep: Rep):
    """``bilinear_weights``' map as the nonzeros of its quadratic form:
    four int64 arrays ``(J, O, I, P)`` with
    ``(W(x) x)[o] = sum over entries of params[P] * x[J] * x[I]``.  Entry
    ``(w, s, k)`` of a type ``rep`` is its weight column ``w * size + s``
    (placed at ``(o, i)`` by the inverse permutation), its parameter
    ``offset + w * n + k`` and its sampled coordinate
    ``reduced[rep][k * size + s]``.  Repeated ``(o, j, i)`` are left
    unmerged."""
    W_mult, ns, reduced, inv_perm, _ = bilinear_layout(out_rep, in_rep)
    nin = in_rep.size()
    # flat (o * nin + i) position of each canonical weight column
    pos = np.argsort(inv_perm)
    J, O, I, P = [], [], [], []
    col = p_off = 0
    for rep, wm in W_mult.items():
        size = rep.size()
        if rep in ns:
            n = ns[rep]
            w, s, k = np.meshgrid(np.arange(wm), np.arange(size),
                                  np.arange(n), indexing="ij")
            flat = pos[col + w * size + s]
            J.append(reduced[rep][k * size + s].reshape(-1))
            O.append((flat // nin).reshape(-1))
            I.append((flat % nin).reshape(-1))
            P.append((p_off + w * n + k).reshape(-1))
            p_off += wm * n
        col += wm * size
    if not J:
        return tuple(np.zeros(0, np.int64) for _ in range(4))
    return tuple(np.concatenate(a).astype(np.int64) for a in (J, O, I, P))
