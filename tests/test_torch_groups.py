"""The port's group zoo (``gym_rotor_tpu_torch/models/emlp/groups.py``)
against the JAX package's: every class and factory, its generators, flags,
name and equality, and the samples a seeded ``np.random.Generator`` draws,
all bit for bit (both are host NumPy and SciPy)."""
import numpy as np
import pytest

from gym_rotor_tpu.models.emlp import groups as jG
from gym_rotor_tpu_torch.models.emlp import groups as tG

# (id, constructor name, args): every class and factory of groups.py
ZOO = [
    ("trivial3", "Trivial", (3,)), ("mirror2", "Mirror", (2,)),
    ("so2", "SO", (2,)), ("so3", "SO", (3,)), ("o3", "O", (3,)),
    ("c4", "C", (4,)), ("d3", "D", (3,)), ("scaling2", "Scaling", (2,)),
    ("parity", "Parity", ()), ("time_reversal", "TimeReversal", ()),
    ("so13p", "SO13p", ()), ("so13", "SO13", ()), ("o13", "O13", ()),
    ("so11p", "SO11p", ()), ("o11", "O11", ()), ("sp2", "Sp", (2,)),
    ("z5", "Z", (5,)), ("s4", "S", (4,)), ("sl3", "SL", (3,)),
    ("gl2", "GL", (2,)), ("u2", "U", (2,)), ("su2", "SU", (2,)),
    ("su3", "SU", (3,)), ("cube", "Cube", ()),
    ("rubiks", "RubiksCube", ()), ("z2s3x3", "ZksZnxZn", (2, 3)),
    ("z4s2x2", "ZksZnxZn", (4, 2)), ("so2er3", "SO2eR3", ()),
    ("o2er3", "O2eR3", ()), ("d4er3", "DkeR3", (4,)),
]


def _pair(name, args):
    return getattr(jG, name)(*args), getattr(tG, name)(*args)


def _same_group(a, b):
    """Generators, flags, size, name and key bit for bit."""
    for f in ("lie_algebra", "discrete_generators"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert (a.d, a.is_orthogonal, a.is_permutation, repr(a), a.key()) == \
        (b.d, b.is_orthogonal, b.is_permutation, repr(b), b.key())
    zs = (a.z_scale, b.z_scale)
    assert (zs[0] is None) == (zs[1] is None)
    if zs[0] is not None:
        assert np.asarray(zs[0]).tobytes() == np.asarray(zs[1]).tobytes()


@pytest.mark.parametrize("name,args", [z[1:] for z in ZOO],
                         ids=[z[0] for z in ZOO])
def test_group_matches_jax_bitwise(name, args):
    """Generators, flags and name; three samples from each of two seeded
    generators (``samples``) and one ``sample``, bit for bit."""
    a, b = _pair(name, args)
    _same_group(a, b)
    for seed in (0, 7):
        sa = a.samples(3, np.random.default_rng(seed))
        sb = b.samples(3, np.random.default_rng(seed))
        assert sa.dtype == sb.dtype and sa.tobytes() == sb.tobytes()
    assert a.sample(np.random.default_rng(1)).tobytes() == \
        b.sample(np.random.default_rng(1)).tobytes()


def test_embed_and_direct_product_match_jax():
    """``Embed`` of any group into any slice (named and not) and
    ``DirectProduct`` of two groups of the zoo, bit for bit; equality by
    value and ``repr`` ordering as in the JAX package."""
    for G in (("SO", (3,)), ("D", (5,)), ("S", (3,))):
        ga, gb = _pair(*G)
        n = ga.d
        _same_group(jG.Embed(ga, n + 2, slice(1, n + 1)),
                    tG.Embed(gb, n + 2, slice(1, n + 1)))
        _same_group(jG.Embed(ga, n + 1, slice(n), name="e"),
                    tG.Embed(gb, n + 1, slice(n), name="e"))
    for p, q in ((("SO", (2,)), ("S", (3,))), (("Mirror", (1,)), ("Z", (3,))),
                 (("O", (2,)), ("SO", (3,)))):
        (pa, pb), (qa, qb) = _pair(*p), _pair(*q)
        a, b = jG.DirectProduct(pa, qa), tG.DirectProduct(pb, qb)
        _same_group(a, b)
        assert a.samples(2, np.random.default_rng(3)).tobytes() == \
            b.samples(2, np.random.default_rng(3)).tobytes()
    assert tG.SO2eR3() == tG.SO2eR3() and tG.SO(3) != tG.O(3)
    ja = sorted(getattr(jG, n)(*a) for _, n, a in ZOO)
    tb = sorted(getattr(tG, n)(*a) for _, n, a in ZOO)
    assert [repr(g) for g in ja] == [repr(g) for g in tb]


def test_cube_helpers_match_jax():
    """``_perm_matrix``, ``_pad48``/``_unpad48`` and ``_rot90_perm``."""
    perm = np.random.default_rng(0).permutation(48)
    assert np.array_equal(jG._perm_matrix(perm), tG._perm_matrix(perm))
    assert np.array_equal(jG._pad48(perm), tG._pad48(perm))
    assert np.array_equal(tG._unpad48(tG._pad48(perm)), perm)
    for n, k in ((3, 1), (4, 2), (2, 3)):
        assert np.array_equal(jG._rot90_perm(n, k), tG._rot90_perm(n, k))
