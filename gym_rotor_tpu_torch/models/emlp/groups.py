"""Symmetry groups for the equivariance engine (own copy of
``gym_rotor_tpu/models/emlp/groups.py``: the whole zoo, from the flagship's
Trivial, Mirror, SO, Embed and SO2eR3 to the general engine's O, C, D,
Lorentz, symplectic, permutation, linear, unitary, cube and product groups).

Groups are NumPy generator containers used only at model-construction
time: the equivariance constraints are solved once on the host and the
bases become constant tensors, so no group code runs on the device.  The
generators and the samples drawn from a given ``np.random.Generator`` are
bit for bit the JAX package's.

A group is defined by its continuous generators (Lie algebra basis) and
discrete generators.  Value equality (class + args) identifies groups, so
``SO2eR3() == SO2eR3()``.
"""
from __future__ import annotations

import numpy as np
from scipy.linalg import expm

MAX_POWER = 5  # matrix-power range for discrete sampling


class Group:
    """Base class; subclasses set lie_algebra (k,d,d) / discrete_generators
    (m,d,d) before calling _init()."""

    lie_algebra: np.ndarray
    discrete_generators: np.ndarray
    d: int
    z_scale = None

    def __init__(self):
        self.args = ()

    def _init(self, *args):
        self.args = args
        if not hasattr(self, "lie_algebra"):
            self.lie_algebra = np.zeros((0, self.d, self.d))
        if not hasattr(self, "discrete_generators"):
            self.discrete_generators = np.zeros((0, self.d, self.d))
        self.lie_algebra = np.asarray(self.lie_algebra, np.float64)
        self.discrete_generators = np.asarray(self.discrete_generators,
                                              np.float64)
        # orthogonality / permutation flags (groups.py:52-74)
        self.is_orthogonal = True
        if len(self.lie_algebra):
            self.is_orthogonal &= bool(
                np.allclose(-np.swapaxes(self.lie_algebra, -1, -2),
                            self.lie_algebra, atol=1e-6))
        if len(self.discrete_generators):
            h = self.discrete_generators
            self.is_orthogonal &= bool(
                np.allclose(np.swapaxes(h, -1, -2) @ h,
                            np.eye(self.d), atol=1e-6))
        self.is_permutation = self.is_orthogonal
        self.is_permutation &= len(self.lie_algebra) == 0
        if len(self.discrete_generators):
            h = self.discrete_generators
            self.is_permutation &= bool(
                ((np.abs(h - 1) < 1e-6).sum(-1) == 1).all())

    # -- identity / hashing by value
    def key(self):
        return (type(self).__name__,) + tuple(self.args)

    def __eq__(self, other):
        return isinstance(other, Group) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def __lt__(self, other):
        """Deterministic ordering for rep canonicalization (the reference
        sorts groups by salted ``hash(repr)``, groups.py:121-123, which is
        nondeterministic across processes; repr-ordering fixes the layout)."""
        return repr(self) < repr(other)

    def __repr__(self):
        a = ",".join(map(str, self.args))
        return f"{type(self).__name__}({a})"

    def num_constraints(self):
        return len(self.lie_algebra) + len(self.discrete_generators)

    def samples(self, n, rng=None):
        """Random group elements (exp of random algebra combos times random
        discrete-generator powers; groups.py:88-100)."""
        rng = rng or np.random.default_rng(0)
        A = self.lie_algebra
        h = self.discrete_generators
        out = []
        for _ in range(n):
            g = np.eye(self.d)
            if len(A):
                z = rng.normal(size=len(A))
                if self.z_scale is not None:
                    z = z * self.z_scale
                g = g @ expm((z[:, None, None] * A).sum(0))
            for hi in h:
                k = rng.integers(-MAX_POWER, MAX_POWER + 1)
                g = g @ np.linalg.matrix_power(hi, k)
            out.append(g)
        return np.stack(out)

    def sample(self, rng=None):
        return self.samples(1, rng)[0]


class Trivial(Group):
    """G = {I} in n dimensions (groups.py:183-188)."""

    def __init__(self, n):
        super().__init__()
        self.d = n
        self._init(n)


class Mirror(Group):
    """G = {I, -I} in n dimensions (groups.py:191-198)."""

    def __init__(self, n):
        super().__init__()
        self.d = n
        self.discrete_generators = -np.eye(n)[None]
        self._init(n)


class SO(Group):
    """Special orthogonal group SO(n) (groups.py:201-212)."""

    def __init__(self, n):
        super().__init__()
        self.d = n
        A = np.zeros(((n * (n - 1)) // 2, n, n))
        k = 0
        for i in range(n):
            for j in range(i):
                A[k, i, j] = 1.0
                A[k, j, i] = -1.0
                k += 1
        self.lie_algebra = A
        self._init(n)


class O(SO):
    """Orthogonal group O(n) (groups.py:216-222)."""

    def __init__(self, n):
        Group.__init__(self)
        self.d = n
        self.lie_algebra = SO(n).lie_algebra
        h = np.eye(n)[None].copy()
        h[0, 0, 0] = -1
        self.discrete_generators = h
        self._init(n)


class C(Group):
    """Cyclic group C_k acting on R^2 (groups.py:225-235)."""

    def __init__(self, k):
        super().__init__()
        self.d = 2
        theta = 2 * np.pi / k
        self.discrete_generators = np.array(
            [[[np.cos(theta), np.sin(theta)],
              [-np.sin(theta), np.cos(theta)]]])
        self._init(k)


class D(Group):
    """Dihedral group D_k in 2 dimensions (groups.py:238-244)."""

    def __init__(self, k):
        super().__init__()
        self.d = 2
        theta = 2 * np.pi / k
        rot = np.array([[np.cos(theta), np.sin(theta)],
                        [-np.sin(theta), np.cos(theta)]])
        refl = np.array([[-1.0, 0.0], [0.0, 1.0]])
        self.discrete_generators = np.stack([rot, refl])
        self._init(k)


class Scaling(Group):
    """Scaling group in n dimensions (groups.py:247-254)."""

    def __init__(self, n):
        super().__init__()
        self.d = n
        self.lie_algebra = np.eye(n)[None]
        self._init(n)


class Parity(Group):
    """Spatial parity in 1+3 dimensions (groups.py:257-264)."""

    def __init__(self):
        super().__init__()
        self.d = 4
        h = -np.eye(4)
        h[0, 0] = 1
        self.discrete_generators = h[None]
        self._init()


class TimeReversal(Group):
    """Time reversal in 1+3 dimensions (groups.py:267-274)."""

    def __init__(self):
        super().__init__()
        self.d = 4
        h = np.eye(4)
        h[0, 0] = -1
        self.discrete_generators = h[None]
        self._init()


class SO13p(Group):
    """Proper orthochronous Lorentz group (groups.py:277-292)."""

    def __init__(self):
        super().__init__()
        self.d = 4
        A = np.zeros((6, 4, 4))
        # rotations embedded in spatial block
        A[3:, 1:, 1:] = SO(3).lie_algebra
        # boosts
        for i in range(3):
            A[i, 1 + i, 0] = A[i, 0, 1 + i] = 1.0
        self.lie_algebra = A
        self.z_scale = np.array([0.3, 0.3, 0.3, 1.0, 1.0, 1.0])
        self._init()


class SO13(SO13p):
    """Lorentz group with PT (groups.py:295-298)."""

    def __init__(self):
        super().__init__()
        self.discrete_generators = -np.eye(4)[None]
        self._init()


class O13(SO13p):
    """Full Lorentz group O(1,3) (groups.py:301-309)."""

    def __init__(self):
        super().__init__()
        h = np.stack([np.eye(4), np.eye(4)])
        h[0] = -h[0]
        h[0, 0, 0] = 1
        h[1, 0, 0] = -1
        self.discrete_generators = h
        self._init()


class SO11p(Group):
    """SO+(1,1): scale/boost group (groups.py:312-318)."""

    def __init__(self):
        super().__init__()
        self.d = 2
        self.lie_algebra = np.array([[[0.0, 1.0], [1.0, 0.0]]])
        self._init()


class O11(SO11p):
    """O(1,1) (groups.py:321-329)."""

    def __init__(self):
        super().__init__()
        h = np.stack([np.eye(2), np.eye(2)])
        h[0] = -h[0]
        h[0, 0, 0] = 1
        h[1, 0, 0] = -1
        self.discrete_generators = h
        self._init()


class Sp(Group):
    """Symplectic group Sp(m), d = 2m (groups.py:332-350)."""

    def __init__(self, m):
        super().__init__()
        self.d = 2 * m
        k = 0
        A = np.zeros((m * (2 * m + 1), self.d, self.d))
        for i in range(m):
            for j in range(m):
                A[k, i, j] = 1
                A[k, m + j, m + i] = -1
                k += 1
        for i in range(m):
            for j in range(i + 1):
                A[k, m + i, j] = 1
                A[k, m + j, i] = 1
                k += 1
                A[k, i, m + j] = 1
                A[k, j, m + i] = 1
                k += 1
        self.lie_algebra = A
        self._init(m)


class Z(Group):
    """Cyclic permutation group Z_n (groups.py:373-379)."""

    def __init__(self, n):
        super().__init__()
        self.d = n
        self.discrete_generators = np.roll(np.eye(n), 1, axis=1)[None]
        self._init(n)


class S(Group):
    """Symmetric (permutation) group S_n (groups.py:382-393)."""

    def __init__(self, n):
        super().__init__()
        self.d = n
        # transpositions (1 i) generate S_n together with an n-cycle; the
        # reference uses the n-1 generators (0 i)
        h = []
        for i in range(1, n):
            p = np.eye(n)
            p[[0, i]] = p[[i, 0]]
            h.append(p)
        self.discrete_generators = np.stack(h) if h else np.zeros((0, n, n))
        self._init(n)


class SL(Group):
    """Special linear group SL(n) (groups.py:396-404)."""

    def __init__(self, n):
        super().__init__()
        self.d = n
        A = []
        for i in range(n):
            for j in range(n):
                if i != j:
                    M = np.zeros((n, n))
                    M[i, j] = 1
                    A.append(M)
        for k in range(n - 1):
            M = np.zeros((n, n))
            M[k, k] = 1
            M[k + 1, k + 1] = -1
            A.append(M)
        self.lie_algebra = np.stack(A)
        self._init(n)


class GL(Group):
    """General linear group GL(n) (groups.py:407-414)."""

    def __init__(self, n):
        super().__init__()
        self.d = n
        A = []
        for i in range(n):
            for j in range(n):
                M = np.zeros((n, n))
                M[i, j] = 1
                A.append(M)
        self.lie_algebra = np.stack(A)
        self._init(n)


class U(Group):
    """Unitary group U(n): complex Lie algebra of anti-Hermitian matrices
    (groups.py:417-440).  Complex generators are supported by the constraint
    solver; the NN layers are real-valued (same practical scope as the
    reference torch port)."""

    def __init__(self, n):
        super().__init__()
        self.d = n
        A = np.zeros((n * n, n, n), dtype=complex)
        k = 0
        for i in range(n):
            for j in range(i):
                A[k, i, j] = 1
                A[k, j, i] = -1
                k += 1
                A[k, i, j] = 1j
                A[k, j, i] = 1j
                k += 1
        for i in range(n):
            A[k, i, i] = 1j
            k += 1
        self.lie_algebra = A
        self._init(n)

    def _init(self, *args):
        # complex-aware flag detection (anti-Hermitian algebra is "unitary")
        self.args = args
        if not hasattr(self, "discrete_generators"):
            self.discrete_generators = np.zeros((0, self.d, self.d),
                                                dtype=complex)
        self.lie_algebra = np.asarray(self.lie_algebra)
        self.discrete_generators = np.asarray(self.discrete_generators)
        self.is_orthogonal = bool(
            np.allclose(-np.conj(np.swapaxes(self.lie_algebra, -1, -2)),
                        self.lie_algebra, atol=1e-6))
        self.is_permutation = False


class SU(U):
    """Special unitary group SU(n): traceless anti-Hermitian algebra
    (groups.py:443-459)."""

    def __init__(self, n):
        Group.__init__(self)
        self.d = n
        full = U(n).lie_algebra
        # project out the trace, then keep a linearly independent subset
        # (n^2 - 1 generators)
        A = []
        for M in full:
            M = M - np.eye(n) * (np.trace(M) / n)
            if np.allclose(M, 0):
                continue
            A.append(M)
        # greedy real-linear-independent subset of the original
        # (anti-Hermitian) generators — su(n) is a real Lie algebra, so
        # independence is over R, and members must stay anti-Hermitian
        kept, basis = [], []
        for M in A:
            v = np.concatenate([M.real.reshape(-1), M.imag.reshape(-1)])
            if basis:
                Bmat = np.stack(basis + [v])
                if np.linalg.matrix_rank(Bmat, tol=1e-9) == len(basis):
                    continue
            basis.append(v)
            kept.append(M)
        self.lie_algebra = np.stack(kept)
        self._init(n)


def _perm_matrix(perm):
    n = len(perm)
    M = np.zeros((n, n))
    M[np.asarray(perm), np.arange(n)] = 1.0
    return M


class Cube(Group):
    """Discrete rotations of a cube acting on its 6 faces
    (groups.py:465-474): generated by the Front and Left quarter-turn face
    permutations."""

    def __init__(self):
        super().__init__()
        self.d = 6
        Fperm = [4, 1, 0, 3, 5, 2]
        Lperm = [3, 0, 2, 5, 4, 1]
        self.discrete_generators = np.stack(
            [_perm_matrix(Fperm), _perm_matrix(Lperm)])
        self._init()


def _pad48(perm):
    """48-facet permutation -> 6x9 grid with face centers (groups.py:477-483)."""
    padded = np.zeros((6, 9), dtype=np.int64)
    r = perm.reshape(6, 8)
    padded[:, :4] = r[:, :4]
    padded[:, 5:] = r[:, 4:]
    return padded


def _unpad48(padded):
    return np.concatenate([padded[:, :4], padded[:, 5:]], -1).reshape(-1)


class RubiksCube(Group):
    """Rubik's cube group G < S_48: all valid 3x3 cube transformations,
    generated by quarter turns of the six faces (groups.py:512-551).
    Face order U,F,R,B,L,D."""

    def __init__(self):
        super().__init__()
        self.d = 48
        order_padded = _pad48(np.arange(48))
        # Up quarter turn: rotate the top face, cycle the adjacent strips
        order_padded[0, :] = np.rot90(
            order_padded[0].reshape(3, 3), 1).reshape(9)
        FRBL = np.array([1, 2, 3, 4])
        order_padded[FRBL, :3] = order_padded[np.roll(FRBL, 1), :3]
        Uperm = _unpad48(order_padded)
        # whole-cube rotations to conjugate the Up turn onto other faces
        RotFront = _pad48(np.arange(48))
        URDL = np.array([0, 2, 5, 4])
        RotFront[URDL, :] = RotFront[np.roll(URDL, 1), :]
        RotFront = _unpad48(RotFront)
        RotBack = np.argsort(RotFront)
        RotLeft = _pad48(np.arange(48))
        UFDB = np.array([0, 1, 5, 3])
        RotLeft[UFDB, :] = RotLeft[np.roll(UFDB, 1), :]
        RotLeft = _unpad48(RotLeft)
        RotRight = np.argsort(RotLeft)

        Fperm = RotRight[Uperm[RotLeft]]
        Rperm = RotBack[Uperm[RotFront]]
        Bperm = RotLeft[Uperm[RotRight]]
        Lperm = RotFront[Uperm[RotBack]]
        Dperm = RotRight[RotRight[Uperm[RotLeft[RotLeft]]]]
        self.discrete_generators = np.stack(
            [_perm_matrix(p) for p in
             [Uperm, Fperm, Rperm, Bperm, Lperm, Dperm]])
        self._init()


def _rot90_perm(n, times):
    """Permutation matrix rotating an n x n grid by 90 deg ``times`` times."""
    idx = np.arange(n * n).reshape(n, n)
    rot = np.rot90(idx, times).reshape(-1)
    return _perm_matrix(rot)


class ZksZnxZn(Group):
    """GCNN group Z_k x| (Z_n x Z_n): 2D translations + discrete rotations
    (groups.py:554-571)."""

    def __init__(self, k, n):
        super().__init__()
        assert k in (2, 4)
        self.d = k * n * n
        nshift = Z(n).discrete_generators[0]
        kshift = Z(k).discrete_generators[0]
        In = np.eye(n)
        Ik = np.eye(k)
        self.discrete_generators = np.stack([
            np.kron(Ik, np.kron(nshift, In)),
            np.kron(Ik, np.kron(In, nshift)),
            np.kron(kshift, _rot90_perm(n, 4 // k)),
        ])
        self._init(k, n)


class Embed(Group):
    """Embed a group's base representation into a larger vector space
    (groups.py:574-592): generators act on dim_slice, identity elsewhere."""

    def __init__(self, G, d, dim_slice, name=None):
        super().__init__()
        self.d = d
        nA = len(G.lie_algebra)
        nh = len(G.discrete_generators)
        A = np.zeros((nA, d, d))
        h = np.zeros((nh, d, d)) + np.eye(d)
        A[:, dim_slice, dim_slice] = G.lie_algebra
        h[:, dim_slice, dim_slice] = G.discrete_generators
        self.lie_algebra = A
        self.discrete_generators = h
        self._name = name or f"{G}_R{d}"
        self._init(self._name)

    def __repr__(self):
        return self._name


def SO2eR3():
    """SO(2) embedded in R^3: rotations about the z axis
    (groups.py:595-597)."""
    return Embed(SO(2), 3, slice(2), name="SO2eR3")


def O2eR3():
    """O(2) embedded in R^3 (groups.py:600-602)."""
    return Embed(O(2), 3, slice(2), name="O2eR3")


def DkeR3(k):
    """Dihedral D_k embedded in R^3 (groups.py:605-607)."""
    return Embed(D(k), 3, slice(2), name=f"D{k}eR3")


class DirectProduct(Group):
    """Direct product G1 x G2 acting on R^{d1*d2} via Kronecker structure
    (groups.py:610-624)."""

    def __init__(self, G1, G2):
        super().__init__()
        I1, I2 = np.eye(G1.d), np.eye(G2.d)
        self.d = G1.d * G2.d
        # kronsum(A1, 0) = A1 (x) I2 ; kronsum(0, A2) = I1 (x) A2
        lie = [np.kron(A1, I2) for A1 in G1.lie_algebra]
        lie += [np.kron(I1, A2) for A2 in G2.lie_algebra]
        self.lie_algebra = (np.stack(lie) if lie
                            else np.zeros((0, self.d, self.d)))
        h = [np.kron(h1, I2) for h1 in G1.discrete_generators]
        h += [np.kron(I1, h2) for h2 in G2.discrete_generators]
        self.discrete_generators = (np.stack(h) if h
                                    else np.zeros((0, self.d, self.d)))
        self._init(G1.key(), G2.key())
