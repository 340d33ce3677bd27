"""Representation algebra + blockwise equivariance solver (own copy of
``gym_rotor_tpu/models/emlp/reps.py``: Atom, SumRep, Vector, Scalar,
uniform_rep, pair_basis, vec_basis, group_by_type, product_type_key).

Representations are lists of tensor-type atoms T(p, q) of a concrete group;
equivariant bases are solved on the host in NumPy once per atom pair (dense
SVD null space, tolerance 1e-5) and used by the layers as constants.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from .groups import Group, Trivial

NULLSPACE_TOL = 1e-5  # singular-value threshold (reps/utils.py:90)


@dataclass(frozen=True)
class Atom:
    """A tensor-type representation T(p,q) of a concrete group."""
    G: Group
    p: int
    q: int = 0

    @property
    def rank(self) -> int:
        return self.p + self.q

    @property
    def size(self) -> int:
        return self.G.d ** self.rank if self.rank else 1

    @property
    def is_scalar(self) -> bool:
        return self.rank == 0

    @property
    def is_permutation(self) -> bool:
        """Whether the rep acts by permutations — controls gating
        (nn.py:58-65, 262-280)."""
        return self.G.is_permutation

    def key(self):
        # orthogonal groups: V ≅ V*, so only total rank matters
        if self.G.is_orthogonal:
            return (self.G.key(), self.rank)
        return (self.G.key(), self.p, self.q)

    def rho(self, g: np.ndarray) -> np.ndarray:
        """Dense rho(g) = g^{(x)p} (x) (g^{-T})^{(x)q}."""
        out = np.eye(1)
        for _ in range(self.p):
            out = np.kron(out, g)
        if self.q:
            gi = np.linalg.inv(g).T
            for _ in range(self.q):
                out = np.kron(out, gi)
        return out

    def drho(self, A: np.ndarray) -> np.ndarray:
        """Dense drho(A): sum over tensor slots of I x..x A x..x I (with -A^T
        in dual slots)."""
        d = self.G.d
        n = self.size
        out = np.zeros((n, n), dtype=np.result_type(A.dtype, np.float64))
        mats = [A] * self.p + [-A.T] * self.q
        for slot in range(self.rank):
            term = np.eye(1)
            for j in range(self.rank):
                term = np.kron(term, mats[slot] if j == slot else np.eye(d))
            out += term
        return out

    def __repr__(self):
        if self.is_scalar:
            return f"S({self.G})"
        return f"T{self.p},{self.q}({self.G})"


class SumRep:
    """Ordered direct sum of atoms (the layout order IS the coordinate
    order; no hidden canonicalization — grouping/permutation happens inside
    the layers that need it)."""

    def __init__(self, atoms: Sequence[Atom]):
        self.atoms: List[Atom] = list(atoms)

    @property
    def size(self) -> int:
        return sum(a.size for a in self.atoms)

    def __add__(self, other: "SumRep") -> "SumRep":
        return SumRep(self.atoms + other.atoms)

    def __radd__(self, other):
        if other == 0:
            return self
        return NotImplemented

    def __mul__(self, n: int) -> "SumRep":
        return SumRep(self.atoms * n)

    __rmul__ = __mul__

    def __eq__(self, other):
        return (isinstance(other, SumRep)
                and [a.key() for a in self.atoms]
                == [a.key() for a in other.atoms])

    def __hash__(self):
        # a rep is never changed once built, and the training path keys its
        # per-layer caches on reps thousands of times per update
        h = self.__dict__.get("_hash")
        if h is None:
            h = self._hash = hash(tuple(a.key() for a in self.atoms))
        return h

    def rho_dense(self, assignments: Dict[Group, np.ndarray]) -> np.ndarray:
        """Block-diagonal rho for a dict {group: element} (groups not in the
        dict act as identity) — used by equivariance tests."""
        blocks = []
        for a in self.atoms:
            g = None
            for G, el in assignments.items():
                if G == a.G:
                    g = el
            blocks.append(a.rho(g) if g is not None else np.eye(a.size))
        n = self.size
        out = np.zeros((n, n))
        i = 0
        for b in blocks:
            out[i:i + b.shape[0], i:i + b.shape[0]] = b
            i += b.shape[0]
        return out

    def __repr__(self):
        return "+".join(map(repr, self.atoms))


def Vector(G: Group) -> SumRep:
    return SumRep([Atom(G, 1, 0)])


def Scalar(G: Group = None) -> SumRep:
    return SumRep([Atom(G if G is not None else Trivial(1), 0, 0)])


# ----------------------------------------------------------------------------
# uniform_rep channel-allocation heuristic (reference nn.py:102-150)
# ----------------------------------------------------------------------------
def lambertW(ch: int, d: int) -> int:
    """Solution to x * d^x <= ch (nn.py:127-133)."""
    max_rank = 0
    while (max_rank + 1) * d ** max_rank <= ch:
        max_rank += 1
    return max_rank - 1


def uniform_rep(ch: int, G: Group) -> SumRep:
    """Distribute ch channels across tensor ranks (nn.py:102-124).

    For orthogonal groups the reference's binomial split of rank r into
    T(k, r-k) allocations is representation-theoretically inert (V ≅ V*), so
    the allocation is deterministic N_r * T(r) here."""
    d = G.d
    Ns = np.zeros((lambertW(ch, d) + 1,), dtype=int)
    while ch > 0:
        max_rank = lambertW(ch, d)
        Ns[:max_rank + 1] += np.array(
            [d ** (max_rank - r) for r in range(max_rank + 1)], dtype=int)
        ch -= (max_rank + 1) * d ** max_rank
    atoms: List[Atom] = []
    for r, nr in enumerate(Ns):
        atoms.extend([Atom(G, r, 0)] * int(nr))
    return SumRep(atoms)


# ----------------------------------------------------------------------------
# Equivariance constraint solver (blockwise)
# ----------------------------------------------------------------------------
def _nullspace(C: np.ndarray) -> np.ndarray:
    """Orthonormal null-space basis (reps/utils.py:87-91): right singular
    vectors with sigma <= 1e-5; returns (n, r).  Memoised on C's bytes: a
    wide hidden rep repeats few distinct constraint matrices."""
    if C.shape[0] == 0:
        return np.eye(C.shape[1])
    ck = (C.shape, C.tobytes())
    B = _NULL_CACHE.get(ck)
    if B is None:
        U, S, VH = np.linalg.svd(C, full_matrices=True)
        rank = int((S > NULLSPACE_TOL).sum())
        B = _NULL_CACHE[ck] = VH[rank:].conj().T
    return B


_PAIR_CACHE: Dict[tuple, np.ndarray] = {}
_NULL_CACHE: Dict[tuple, np.ndarray] = {}
_ACTION_CACHE: Dict[tuple, tuple] = {}


def _actions(atom: Atom, G: Group):
    """The atom's drho(A) for each Lie generator of ``G`` and (rho(h),
    rho(h)^{-T}) for each discrete one (zero / identity where ``G`` is not
    its group), made once per (atom type, group): a Mirror rank-r atom's
    actions are r-long kron chains, and critic 256's hidden rep holds
    ranks 0 .. 255."""
    ck = (atom.key(), G.key())
    hit = _ACTION_CACHE.get(ck)
    if hit is None:
        n = atom.size
        acts = G == atom.G
        lie = [atom.drho(A) if acts else np.zeros((n, n))
               for A in G.lie_algebra]
        disc = []
        for h in G.discrete_generators:
            r = atom.rho(h) if acts else np.eye(n)
            disc.append((r, np.linalg.inv(r).T))
        hit = _ACTION_CACHE[ck] = (lie, disc)
    return hit


def pair_basis(atom_out: Atom, atom_in: Atom) -> np.ndarray:
    """Orthonormal basis of equivariant linear maps atom_in -> atom_out,
    flattened row-major: (size_out * size_in, r).

    Constraints: for every generator of every involved group,
    drho_out(A) W - W drho_in(A) = 0 and rho_out(h) W rho_in(h)^{-1} = W;
    generators of a group act as zero/identity on atoms of other groups
    (different-group sums behave like a direct product, matching the
    reference's DeferredProductRep semantics)."""
    ck = (atom_out.key(), atom_in.key())
    if ck in _PAIR_CACHE:
        return _PAIR_CACHE[ck]
    no, ni = atom_out.size, atom_in.size
    Io, Ii = np.eye(no), np.eye(ni)
    groups = [atom_out.G]
    if atom_in.G != atom_out.G:
        groups.append(atom_in.G)
    rows = []
    for G in groups:
        lie_o, disc_o = _actions(atom_out, G)
        lie_i, disc_i = _actions(atom_in, G)
        for dro, dri in zip(lie_o, lie_i):
            rows.append(np.kron(dro, Ii) - np.kron(Io, dri.T))
        for (ro, _), (_, ri_invT) in zip(disc_o, disc_i):
            rows.append(np.kron(ro, ri_invT) - np.eye(no * ni))
    C = np.concatenate(rows, axis=0) if rows else np.zeros((0, no * ni))
    B = _nullspace(C)
    _PAIR_CACHE[ck] = B
    return B


def vec_basis(atom: Atom) -> np.ndarray:
    """Orthonormal basis of invariant vectors in the atom (bias space):
    null space of {drho(A); rho(h) - I} (representation.py:87-97)."""
    return pair_basis(atom, Atom(Trivial(1), 0, 0))


# ----------------------------------------------------------------------------
# Type grouping (the layout machinery used by the layers)
# ----------------------------------------------------------------------------
@dataclass
class TypeGroup:
    key: tuple
    atom: Atom
    mult: int
    indices: np.ndarray      # (mult * size,) original coordinate indices
    atom_positions: List[int]  # positions of the atoms within rep.atoms


def group_by_type(rep: SumRep) -> List[TypeGroup]:
    """Group a SumRep's atoms by type, preserving first-appearance order;
    the reference achieves this via SumRep canonicalization + perm
    bookkeeping (representation.py:405-530)."""
    offsets = []
    off = 0
    for a in rep.atoms:
        offsets.append(off)
        off += a.size
    seen: Dict[tuple, TypeGroup] = {}
    order: List[tuple] = []
    for pos, a in enumerate(rep.atoms):
        k = a.key()
        if k not in seen:
            seen[k] = TypeGroup(key=k, atom=a, mult=0,
                                indices=np.zeros(0, np.int64),
                                atom_positions=[])
            order.append(k)
        tg = seen[k]
        tg.mult += 1
        tg.indices = np.concatenate(
            [tg.indices, offsets[pos] + np.arange(a.size)])
        tg.atom_positions.append(pos)
    return [seen[k] for k in order]


def product_type_key(atom_out: Atom, atom_in: Atom):
    """Type key of atom_out (x) atom_in* as it appears inside the bilinear
    weight rep (representation.py:358-402).

    Scalars are the multiplicative identity regardless of their group (the
    reference's ScalarRep.__mul__ semantics); same-group products collapse
    to a higher-rank tensor of that group; cross-group products can never
    match a single-group atom of the input and are keyed separately."""
    if atom_out.is_scalar:
        return atom_in.key()
    if atom_in.is_scalar:
        return atom_out.key()
    if atom_out.G == atom_in.G and atom_out.G.is_orthogonal:
        return (atom_out.G.key(), atom_out.rank + atom_in.rank)
    return (atom_out.key(), atom_in.key())
