"""Symmetry groups for the equivariant layers (own copy of the subset of
``gym_rotor_tpu/models/emlp/groups.py`` the flagship actors use: Trivial,
Mirror, SO, Embed, SO2eR3).

Groups are NumPy generator containers used only at model-construction
time: the equivariance constraints are solved once on the host and the
bases become constant tensors, so no group code runs on the device.
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
