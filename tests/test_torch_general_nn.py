"""The port's general EMLP (``gym_rotor_tpu_torch/models/emlp/general_nn.py``)
against the JAX package's ``general_nn``: channel allocation, gates, each
layer, the block (which runs K3/K4's plain twins through the general
``BlockSpec``, the index form the card's kernels take) and the network,
from flax's parameters carried across by ``convert``.

Tolerances: ``uniform_rep`` allocations, ``binomial_allocation`` and
``gate_indices`` bit for bit (host NumPy on both sides); forwards and the
parameters' gradients within 1e-9 of max |JAX| in float64 and 1e-5 in
float32 (the same sums in another order); the port's own network
equivariant to 1e-4 end to end and 1e-5 for an invariant output (the
bounds of ``tests/test_general_nn.py``); the parameter round trip through
``convert`` bit for bit.  The JAX side runs jitted (its eager init and
gradient take seconds a network), each reference made once a module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_rotor_tpu.models.emlp import general_nn as jgnn
from gym_rotor_tpu.models.emlp import groups as jG
from gym_rotor_tpu.models.emlp import rep_algebra as jra
from gym_rotor_tpu_torch import convert
from gym_rotor_tpu_torch.kernels import emlp_block as K
from gym_rotor_tpu_torch.models.emlp import general_nn as tgnn
from gym_rotor_tpu_torch.models.emlp import groups as tG
from gym_rotor_tpu_torch.models.emlp import rep_algebra as tra

TOL = {torch.float64: 1e-9, torch.float32: 1e-5}
NP = {torch.float64: np.float64, torch.float32: np.float32}


def both(mk):
    return mk(jra, jG), mk(tra, tG)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(
        float(np.abs(want).max()), 1e-300)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        else:
            out[pre + k] = np.asarray(v)
    return out


def _jax_reference(module, x, seed):
    """Flax params from a jitted ``init`` (float64), and a function of the
    dtype giving JAX's output and the gradients of sum(y**2) in that
    dtype, jitted once per dtype."""
    params = jax.tree.map(np.asarray, jax.jit(module.init)(
        jax.random.PRNGKey(seed), jnp.asarray(x)))
    f = jax.jit(jax.value_and_grad(
        lambda p, x: jnp.sum(module.apply(p, x) ** 2)))
    y = jax.jit(module.apply)
    done = {}

    def at(dtype):
        if dtype not in done:
            p = jax.tree.map(lambda a: a.astype(NP[dtype]), params)
            xd = jnp.asarray(x.astype(NP[dtype]))
            done[dtype] = (np.asarray(y(p, xd)),
                           _flat(f(p, xd)[1]["params"]))
        return done[dtype]
    return params, at


def _port_vs_jax(module, params, at, x, dtype):
    """The port module from flax's parameters in ``dtype``: output and
    every parameter's gradient of sum(y**2) against JAX's."""
    module = module.to(dtype)
    module.load_state_dict(convert.module_params_from_jax(params, module))
    xt = torch.from_numpy(x.astype(NP[dtype]))
    y = module(xt)
    (y ** 2).sum().backward()
    yj, gj = at(dtype)
    assert y.dtype == dtype and _rel(y.detach().numpy(), yj) < TOL[dtype]
    for k, p in module.named_parameters():
        g = np.zeros(p.shape) if p.grad is None else p.grad.numpy()
        assert _rel(g, gj[k]) < TOL[dtype], k
    return module


# ----------------------------------------------------------------------------
# Allocation and gates
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("ch,grp", [(24, "SO"), (96, "SO"), (384, "SO"),
                                    (100, "S"), (40, "Mirror")])
def test_uniform_rep_matches_jax(ch, grp):
    """``lambertW`` and ``uniform_rep``'s allocation (its seeded binomial
    remainder), canonical order and size, bit for bit."""
    n = {"SO": 3, "S": 4, "Mirror": 2}[grp]
    a = jgnn.uniform_rep(ch, getattr(jG, grp)(n))
    b = tgnn.uniform_rep(ch, getattr(tG, grp)(n))
    assert tgnn.lambertW(ch, n) == jgnn.lambertW(ch, n)
    assert (repr(a), a.size()) == (repr(b), b.size()) and b.size() == ch
    assert [(repr(r), c) for r, c in a.reps.items()] == \
        [(repr(r), c) for r, c in b.reps.items()]
    assert np.array_equal(a.perm, b.perm)


def test_binomial_allocation_matches_jax():
    """The binomial split of 13 rank-3 tensors from a seeded generator: bit
    for bit over O(3); over SL(2), whose T(k, 3 - k) tie in group and size
    (the JAX package breaks that tie by Python's salted hash, so its order
    changes from process to process), the same reps and counts."""
    ra = jgnn.binomial_allocation(13, 3, jG.O(3), np.random.default_rng(4))
    rb = tgnn.binomial_allocation(13, 3, tG.O(3), np.random.default_rng(4))
    assert repr(ra) == repr(rb) and np.array_equal(ra.perm, rb.perm)
    ra = jgnn.binomial_allocation(13, 3, jG.SL(2), np.random.default_rng(4))
    rb = tgnn.binomial_allocation(13, 3, tG.SL(2), np.random.default_rng(4))
    assert {repr(r): c for r, c in ra.reps.items()} == \
        {repr(r): c for r, c in rb.reps.items()}
    assert sum(ra.reps.values()) == 13 and rb.size() == ra.size()


GATED = {
    "so3_mixed": lambda ra, G: (2 * ra.V + 3 * ra.Scalar)(G.SO(3)),
    "s4_regular": lambda ra, G: (1 * ra.V + ra.V ** 2)(G.S(4)),
    "so3_reordered": lambda ra, G: (ra.V ** 2 + ra.V + ra.Scalar + ra.V)(
        G.SO(3)),
    "o2_single": lambda ra, G: ra.V(G.O(2)),
}


@pytest.mark.parametrize("name", sorted(GATED))
def test_gates_match_jax(name):
    """``gated`` (its layout and permutation) and ``gate_indices``."""
    a, b = both(GATED[name])
    ga, gb = jgnn.gated(a), tgnn.gated(b)
    assert (repr(ga), ga.size()) == (repr(gb), gb.size())
    assert np.array_equal(ga.perm, gb.perm)
    assert np.array_equal(jgnn.gate_indices(a), tgnn.gate_indices(b))


# ----------------------------------------------------------------------------
# Layers
# ----------------------------------------------------------------------------
LAYER_CASES = ("linear", "bilinear", "block", "block_relabelled")


def _layer(name, ra, G, gnn):
    """The layer case ``name`` and its input width."""
    Grp = G.SO(3) if name != "linear" else G.O(3)
    if name == "linear":
        rin = (2 * ra.V + ra.Scalar)(Grp)
        return gnn.GeneralEquivLinear(rin, (ra.V + 2 * ra.Scalar)(Grp)), \
            rin.size()
    if name == "bilinear":
        rep = (2 * ra.V + ra.V ** 2 + 3 * ra.Scalar)(Grp)
        return gnn.GeneralBiLinear(rep, rep), rep.size()
    rin = (ra.V + ra.Scalar)(Grp)
    rout = ((2 * ra.V + ra.V ** 2 + 2 * ra.Scalar) if name == "block"
            else (ra.V ** 2 + ra.Scalar + ra.V))(Grp)
    return gnn.GeneralEMLPBlock(rin, rout), rin.size()


@pytest.fixture(scope="module")
def layer_refs():
    """Per layer case: the flax module's params, its reference and the
    input."""
    out = {}
    for name in LAYER_CASES:
        jm, nin = _layer(name, jra, jG, jgnn)
        x = np.random.default_rng(3).normal(size=(6, nin))
        params, at = _jax_reference(jm, x, 5)
        out[name] = (params, at, x)
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", LAYER_CASES)
def test_layer_matches_jax(layer_refs, name, dtype):
    """``GeneralEquivLinear``, ``GeneralBiLinear`` (dense ``W(x)``) and
    ``GeneralEMLPBlock`` (K3/K4's twins through its spec; one block whose
    gate coordinates are relabelled for the kernels' layout): forward and
    gradients from flax's parameters."""
    params, at, x = layer_refs[name]
    module = _port_vs_jax(_layer(name, tra, tG, tgnn)[0], params, at, x,
                          dtype)
    if name.startswith("block"):
        spec = K.general_block_spec(module, "cpu")
        assert spec.runtime_only and \
            (spec.rows is not None) == (name == "block_relabelled")
        with torch.no_grad():
            xt = torch.from_numpy(x.astype(NP[dtype]))
            assert _rel(module(xt), module.forward_layers(xt)) < TOL[dtype]


def test_general_spec_merges_repeats_and_routes_to_runtime():
    """The general block's spec: repeated ``(o, j, i)`` of the sampled
    bilinear map merged (its ``v`` the summed ``bi_params``), sorted by
    output, every output's gate an output that gates itself or a
    coordinate past ``nh`` in atom order; ``emlp_block`` on it runs the
    run-time wrappers' twins."""
    G = tG.SO(3)
    blk = tgnn.GeneralEMLPBlock((tra.V + tra.Scalar)(G),
                                (tra.V ** 2 + tra.Scalar + 2 * tra.V)(G))
    spec = K.general_block_spec(blk, "cpu")
    J, O, I, P = tra.bilinear_nonzeros(blk.grep, blk.grep)
    assert spec.nnz < len(J) and spec.dims == (4, 19, 16)
    assert spec.rows is not None
    o = spec.idx["o"].numpy()
    assert (np.diff(o) >= 0).all()
    gate = spec.gate
    own = gate == np.arange(len(gate))
    assert ((gate >= spec.nh) | own).all()
    tail = gate[gate >= spec.nh]
    assert np.array_equal(np.unique(tail), np.arange(spec.nh, spec.ng))
    assert (np.diff(tail) >= 0).all()
    K.rt_atoms(gate, spec.nh)
    bp = torch.randn(blk.bilinear.wdim, dtype=torch.float64)
    v = K.merged_values(spec, bp)
    assert torch.allclose(v.sum(), bp[torch.as_tensor(P)].sum())


# ----------------------------------------------------------------------------
# The network
# ----------------------------------------------------------------------------
NETS = {
    "so3": ("SO", 3, "V", 24, 2), "s4": ("S", 4, "V", 24, 2),
    "mirror2": ("Mirror", 2, "V", 24, 2),
    "ch_int": ("SO", 3, "T0", 20, 2), "ch_rep": ("SO", 3, "T0", "hidden", 2),
    "ch_list": ("SO", 3, "T0", "list", 2),
}


def _net(name, ra, G, gnn, **kw):
    grp, n, out, ch, layers = NETS[name]
    hidden = 4 * ra.V + 6 * ra.Scalar
    ch = {"hidden": hidden, "list": [20, hidden]}.get(ch, ch)
    rout = ra.V if out == "V" else ra.T(0)
    make = getattr(G, grp)(n)
    if gnn is jgnn:
        return gnn.GeneralEMLP(rep_in=ra.V, rep_out=rout, group=make, ch=ch,
                               num_layers=layers), n
    return gnn.GeneralEMLP(ra.V, rout, make, ch=ch, num_layers=layers,
                           **kw), n


@pytest.fixture(scope="module")
def net_refs():
    out = {}
    for name in NETS:
        jm, n = _net(name, jra, jG, jgnn)
        x = np.random.default_rng(1).normal(size=(5, n))
        out[name] = _jax_reference(jm, x, 1) + (x,)
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_general_emlp_matches_jax(net_refs, name, dtype):
    """``GeneralEMLP`` V -> V over SO(3), S(4) and Mirror(2), and V -> T(0)
    with ``ch`` an int, a Rep and a list: output and every parameter's
    gradient from flax's parameters."""
    params, at, x = net_refs[name]
    module = _port_vs_jax(_net(name, tra, tG, tgnn)[0], params, at, x, dtype)
    assert sorted(n for n, _ in module.named_parameters()) == \
        sorted(_flat(params["params"]))


def test_convert_round_trip(net_refs):
    """flax's tree -> the port's state dict -> flax's tree, bit for bit
    and in flax's key order."""
    params, _, _ = net_refs["ch_list"]
    module = _net("ch_list", tra, tG, tgnn, dtype=torch.float64)[0]
    sd = convert.module_params_from_jax(params, module)
    module.load_state_dict(sd)
    back = convert.module_params_to_jax(module.state_dict(), module)
    fa, fb = _flat(params["params"]), _flat(back["params"])
    assert list(fb) == sorted(fa)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].tobytes() == \
            fb[k].tobytes(), k


@pytest.mark.parametrize("grp,n", [("SO", 3), ("S", 4), ("Mirror", 2)])
def test_port_network_is_equivariant(grp, n):
    """The port's own seeded network (float32) V -> V within 1e-4 under a
    sampled element, and V -> T(0) over SO(3) invariant within 1e-5."""
    G = getattr(tG, grp)(n)
    gen = torch.Generator().manual_seed(2)
    net = tgnn.GeneralEMLP(tra.V, tra.V, G, ch=24, num_layers=2,
                           generator=gen)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(5, n))
                         .astype(np.float32))
    g = torch.from_numpy(G.samples(1, np.random.default_rng(9))[0]
                         .astype(np.float32))
    with torch.no_grad():
        y, yg = net(x), net(x @ g.T)
    assert float((yg - y @ g.T).abs().max() / (y.abs().max() + 1e-8)) < 1e-4
    if grp == "SO":
        inv = tgnn.GeneralEMLP(tra.V, tra.T(0), G, ch=16, num_layers=1,
                               generator=gen)
        with torch.no_grad():
            y, yg = inv(x), inv(x @ g.T)
        assert float((yg - y).abs().max() / (y.abs().max() + 1e-8)) < 1e-5
