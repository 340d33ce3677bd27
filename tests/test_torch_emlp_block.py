"""K3/K4's index and function on the CPU: the coordinate-major lists, the
gate's inverse and the backward plans the kernels walk (for the 16 block
instances the learners launch), the gather form those lists define against
the plain twin, the twins against flax's ``EMLPBlock`` and ``jax.vjp`` for
the blocks ``test_torch_td3.py`` does not hold (the hidden, actor, PPO V,
MONO and CTDE blocks), and the forward that saves nothing when autograd
records nothing.  The CUDA kernels themselves are held to the twins by
``chip_smoke.py`` on the card.

Tolerances.  The gather form against the twin: float64, 1e-12 of the
largest entry (the same sums in another order).  The twins against flax:
float64, 1e-9 of the largest entry, as ``test_emlp_block_matches_flax``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_rotor_tpu.models.emlp import nn as jnn
from gym_rotor_tpu.models.emlp import zoo as jzoo
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch.algos.ppo import PPOAgent
from gym_rotor_tpu_torch.algos.td3 import TD3Agent
from gym_rotor_tpu_torch.kernels import emlp_block as kblock
from gym_rotor_tpu_torch.models.emlp import nn as tnn
from gym_rotor_tpu_torch.models.emlp import zoo as tzoo
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from torch_jax_fixtures import jax_rho_memo  # noqa: F401

torch.set_num_threads(1)
SMS = 132                       # an H100's SMs, which set the plans' groups
ROWS = (1, 31, 33, 128, 255, 256, 768, 1024, 3723)
INSTANCES = sorted(kblock.INSTANCES)


@functools.lru_cache(maxsize=None)
def _specs():
    """Every block of the learners at full width, by (nin, ng, nh)."""
    specs = {}
    for kw in ({}, {"framework": "MONO"}, {"module_training": "CTDE"}):
        cfg = TConfig(**kw)
        for i in range(cfg.n_agents):
            td3 = TD3Agent(cfg, i, "cpu")
            ppo = PPOAgent(cfg.replace(rl_algo="PPO"), i, "cpu")
            for net, prefix in ((td3.actor_net.network, "network."),
                                (td3.critic_net.network1, "network1."),
                                (ppo.critic_net.network, "network.")):
                for _, blk in net.named_blocks(prefix):
                    spec = kblock.block_spec(blk, "cpu")
                    specs[spec.dims] = spec
    return specs


def _spec(dims):
    return _specs()[dims]


def test_the_learners_launch_the_sixteen_instances():
    assert set(_specs()) == kblock.INSTANCES


# ---------------------------------------------------------------------------
# The index
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dims", INSTANCES, ids=str)
def test_coordinate_lists_and_gate_inverse(dims):
    """Each nonzero sits once in the list of each endpoint (twice in one
    list where ``j == i``) with its output and the other endpoint as
    partner; the gate's inverse lists each output under its gate source."""
    spec = _spec(dims)
    o, j, i = (spec.idx[k].numpy() for k in ("o", "j", "i"))
    ptr, e, lo, partner = spec.lists
    assert ptr[0] == 0 and ptr[-1] == 2 * spec.nnz and len(ptr) == spec.ng + 1
    assert np.all(np.diff(ptr) >= 0)
    owner = np.repeat(np.arange(spec.ng), np.diff(ptr))
    got = sorted(zip(owner, e, partner))
    want = sorted([(j[k], k, i[k]) for k in range(spec.nnz)]
                  + [(i[k], k, j[k]) for k in range(spec.nnz)])
    assert got == want
    np.testing.assert_array_equal(lo, o[e])
    assert np.bincount(e, minlength=spec.nnz).tolist() == [2] * spec.nnz
    twice = [k for k in range(spec.nnz) if j[k] == i[k]]
    for k in twice:
        c = j[k]
        assert list(e[ptr[c]:ptr[c + 1]]).count(k) == 2
    gptr, ks = spec.ginv
    gate = spec.gidx.numpy()
    for c in range(spec.ng):
        assert list(ks[gptr[c]:gptr[c + 1]]) == \
            [k for k in range(spec.nh) if gate[k] == c]
    assert gptr[-1] == spec.nh
    # gate[k] == k (SiLU) occurs in every instance
    assert np.any(gate == np.arange(spec.nh))


@pytest.mark.parametrize("dims", INSTANCES, ids=str)
def test_kernel_index_layout(dims):
    """``BlockSpec.ints`` holds, in the order of the kernels' ``Ints``,
    the gate, the row pointers, (j, i), o, (j, i) as packed tile offsets,
    the lists (pointers, (o, partner) as packed offsets, the nonzero) and
    the gate's inverse."""
    spec = _spec(dims)
    ng, nh, nnz, P = spec.ng, spec.nh, spec.nnz, kblock.PITCH
    sizes = (nh, ng + 1, nnz, nnz, nnz, ng + 1, 2 * nnz, 2 * nnz, ng + 1,
             nh)
    ints = spec.ints.numpy()
    assert ints.dtype == np.int32 and len(ints) == sum(sizes)
    (gate, rowptr, ji, o, ji_off, cl_ptr, cl_off, cl_e, gptr,
     gk) = np.split(ints, np.cumsum(sizes)[:-1])
    oo, jj, ii = (spec.idx[k].numpy() for k in ("o", "j", "i"))
    np.testing.assert_array_equal(gate, spec.gidx.numpy())
    np.testing.assert_array_equal(rowptr, spec.idx["rowptr"].numpy())
    np.testing.assert_array_equal(ji, jj * 65536 + ii)
    np.testing.assert_array_equal(o, oo)
    np.testing.assert_array_equal(ji_off >> 16, jj * P)
    np.testing.assert_array_equal(ji_off & 0xffff, ii * P)
    ptr, e, lo, partner = spec.lists
    np.testing.assert_array_equal(cl_ptr, ptr)
    np.testing.assert_array_equal(cl_off >> 16, lo * P)
    np.testing.assert_array_equal(cl_off & 0xffff, partner * P)
    np.testing.assert_array_equal(cl_e, e)
    np.testing.assert_array_equal(gptr, spec.ginv[0])
    np.testing.assert_array_equal(gk, spec.ginv[1])


@pytest.mark.parametrize("dims", INSTANCES, ids=str)
def test_forward_plans_cover_every_output_once(dims):
    """At every row count of the learners, the edge cases and the GAE
    pass, the forward plan's groups split the outputs into runs of whole
    atoms with their gate coordinates (each coordinate in one group), list
    each group's outputs longest first, hold each output's nonzeros in the
    group's two entry ranges, and fit the shared memory."""
    spec = _spec(dims)
    nnz = np.diff(spec.rowptr)
    for B in ROWS + (13952, 409600):
        G = spec.groups("forward", B, SMS)
        p = spec.plan("forward", G)
        (fo,) = p.arrays
        assert p.meta[0] == G and p.hdr.shape == (G, 10)
        assert p.hdr[0, 0] == 0 and p.hdr[-1, 1] == spec.nh
        assert p.hdr[0, 2] == spec.nh and p.hdr[-1, 3] == spec.ng
        np.testing.assert_array_equal(p.hdr[1:, 0], p.hdr[:-1, 1])
        np.testing.assert_array_equal(p.hdr[1:, 2], p.hdr[:-1, 3])
        np.testing.assert_array_equal(np.sort(fo), np.arange(spec.ng))
        for k0, k1, q0, q1, f0, f1, eh0, eh1, eq0, eq1 in p.hdr:
            assert k1 > k0
            mine = fo[f0:f1]
            assert sorted(mine) == list(range(k0, k1)) + list(range(q0, q1))
            assert np.all(np.diff(nnz[mine]) <= 0)
            gates = spec.gate[k0:k1]
            assert np.all((gates == np.arange(k0, k1))
                          | ((gates >= q0) & (gates < q1)))
            assert (eh0, eh1, eq0, eq1) == tuple(spec.rowptr[[k0, k1, q0, q1]])
        assert p.meta[1] == max(h[7] - h[6] + h[9] - h[8] for h in p.hdr)
        assert kblock.forward_smem(dims, p.meta) <= kblock.SMEM_LIMIT


@pytest.mark.parametrize("dims", INSTANCES, ids=str)
def test_backward_plans_cover_every_coordinate_once(dims):
    """At every row count of the learners and the edge cases, the plan's
    groups partition the coordinates, its segments partition each list in
    order, every segment is dealt to exactly one warp of its group, and no
    block's slice exceeds the shared memory the kernels assume."""
    spec = _spec(dims)
    ptr = spec.lists[0]
    for B in ROWS:
        G = spec.groups("backward", B, SMS)
        p = spec.plan("backward", G)
        wb, seg, cs = p.arrays
        cb = np.concatenate([p.hdr[:, 0], [p.hdr[-1, 1]]])
        assert 1 <= G <= spec.ng and p.meta[0] == G
        assert cb[0] == 0 and cb[-1] == spec.ng and np.all(np.diff(cb) > 0)
        assert cs[0] == 0 and np.all(np.diff(cs) >= 0)
        assert len(wb) == G * kblock.BWD_WARPS + 1 and wb[-1] == len(seg)
        assert sorted(seg[:, 0]) == list(range(cs[-1]))
        by_slot = seg[np.argsort(seg[:, 0])]
        for c in range(spec.ng):
            mine = by_slot[cs[c]:cs[c + 1]]
            edges = [ptr[c]] + list(mine[:, 2])
            assert list(mine[:, 1]) == edges[:-1] and edges[-1] == ptr[c + 1]
            assert np.all(mine[:, 2] > mine[:, 1])
        for g, (c0, c1, e0, e1, s0, s1, g0, g1, v0, v1) in enumerate(p.hdr):
            assert (e0, e1, s0, s1) == (ptr[c0], ptr[c1], cs[c0], cs[c1])
            assert (v0, v1) == tuple(spec.rowptr[[c0, c1]])
            assert (g0, g1) == (wb[g * kblock.BWD_WARPS],
                                wb[(g + 1) * kblock.BWD_WARPS])
            assert sorted(seg[g0:g1, 0]) == list(range(s0, s1))
        span = p.hdr[:, 1::2] - p.hdr[:, 0::2]
        assert p.meta[1:7] == (len(seg), span[:, 1].max(), span[:, 2].max(),
                               span[:, 0].max(), span[:, 3].max(),
                               span[:, 4].max())
        assert kblock.backward_smem(dims, p.meta) <= kblock.SMEM_LIMIT


# ---------------------------------------------------------------------------
# The gather form against the twin
# ---------------------------------------------------------------------------
def _sig(p):
    return 1.0 / (1.0 + torch.exp(-p))


def gather_backward(spec, plan, g_h, v, lin, pre):
    """``(g_pre, g_lin)`` (B, ng) as the backward kernel forms them: g_pre
    from the gate's first term and the gate's inverse, g_lin from the
    plan's segments (0.1 times the sum of v g_pre[o] lin[partner] over a
    segment, in list order) added to g_pre slot by slot."""
    lin, pre = lin.T, pre.T
    gate, (gptr, ks) = spec.gidx, spec.ginv
    g_pre = torch.zeros_like(pre)
    for c in range(spec.ng):
        gp = torch.zeros_like(pre[:, 0])
        if c < spec.nh:
            gp = g_h[:, c] * _sig(pre[:, gate[c]])
        if gptr[c + 1] > gptr[c]:
            s = _sig(pre[:, c])
            for k in ks[gptr[c]:gptr[c + 1]]:
                gp = gp + g_h[:, k] * pre[:, k] * s * (1.0 - s)
        g_pre[:, c] = gp
    _, e, o, partner = spec.lists
    ve = v[torch.as_tensor(e)]
    slots = torch.zeros(int(plan.arrays[2][-1]), pre.shape[0],
                        dtype=pre.dtype)
    for slot, a, b in plan.arrays[1]:
        slots[slot] = 0.1 * (ve[a:b] * g_pre[:, o[a:b]]
                             * lin[:, partner[a:b]]).sum(1)
    g_lin = g_pre.clone()
    cs = plan.arrays[2]
    for c in range(spec.ng):
        for s in range(cs[c], cs[c + 1]):
            g_lin[:, c] = g_lin[:, c] + slots[s]
    return g_pre, g_lin


def _close(got, ref, rel, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref), initial=0.0)), 1e-30)
    err = float(np.max(np.abs(got - ref), initial=0.0))
    assert err <= rel * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"


@pytest.mark.parametrize("B", (1, 31, 33, 256))
@pytest.mark.parametrize("dims", INSTANCES, ids=str)
def test_gather_form_matches_plain_backward(dims, B):
    """g_pre and g_lin by the lists and the plan the kernel gets at ``B``
    rows, against the twin (float64): with W = I the twin's g_x is g_lin,
    and with v = 0 it is g_pre."""
    spec = _spec(dims)
    rng = np.random.default_rng(B + spec.ng)
    f64 = torch.float64
    lin = torch.as_tensor(rng.normal(0, 0.8, (spec.ng, B)), dtype=f64)
    pre = torch.as_tensor(rng.normal(0, 0.8, (spec.ng, B)), dtype=f64)
    g_h = torch.as_tensor(rng.normal(size=(B, spec.nh)), dtype=f64)
    v = torch.as_tensor(rng.normal(0, 0.5, spec.nnz), dtype=f64)
    eye = torch.eye(spec.ng, dtype=f64)
    x = torch.zeros(B, spec.ng, dtype=f64)
    plan = spec.plan("backward", spec.groups("backward", B, SMS))
    g_pre, g_lin = gather_backward(spec, plan, g_h, v, lin, pre)
    ref_lin = kblock.emlp_block_backward_plain(spec, g_h, x, eye, v, lin,
                                               pre, False)[0]
    ref_pre = kblock.emlp_block_backward_plain(
        spec, g_h, x, eye, torch.zeros_like(v), lin, pre, False)[0]
    _close(g_lin, ref_lin, 1e-12, "g_lin")
    _close(g_pre, ref_pre, 1e-12, "g_pre")


# ---------------------------------------------------------------------------
# The twins against flax
# ---------------------------------------------------------------------------
# (reps, framework, module_training, agent, block): block 0 maps the input
# rep to the hidden one, block 1 the hidden rep to itself
FLAX_BLOCKS = (
    ("critic", "MODUL", "DTDE", 0, 1),       # (62, 71, 62)
    ("critic", "MODUL", "DTDE", 1, 1),       # (62, 123, 62)
    ("v_critic", "MODUL", "DTDE", 0, 0),     # (15, 71, 62)
    ("v_critic", "MODUL", "DTDE", 1, 0),     # (3, 123, 62)
    ("actor", "MODUL", None, 0, 0),          # (15, 18, 16)
    ("actor", "MODUL", None, 0, 1),          # (16, 18, 16)
    ("actor", "MODUL", None, 1, 0),          # (3, 7, 4)
    ("actor", "MODUL", None, 1, 1),          # (4, 7, 4)
    ("critic", "MONO", "DTDE", 0, 0),        # (27, 71, 62)
    ("actor", "MONO", None, 0, 0),           # (23, 18, 16)
    ("critic", "MODUL", "CTDE", 0, 0),       # (23, 71, 62), MONO V too
    ("critic", "MODUL", "CTDE", 1, 0),       # (23, 123, 62)
    ("v_critic", "MODUL", "CTDE", 0, 0),     # (18, 71, 62)
    ("v_critic", "MODUL", "CTDE", 1, 0),     # (18, 123, 62)
)


def _reps(zoo, cfg, kind, fw, mt, agent):
    fn = getattr(zoo, f"{kind}_reps")
    return fn(cfg, fw, agent) if kind == "actor" else fn(cfg, fw, agent, mt)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_flax_blocks_cover_the_rest_of_the_instances():
    """With the DTDE critics' first blocks (``test_torch_td3.py``) the
    cases below are the 16 instances."""
    cfg = TConfig()
    seen = {(19, 71, 62), (4, 123, 62)}
    for kind, fw, mt, agent, k in FLAX_BLOCKS:
        rin, hid = _reps(tzoo, cfg, kind, fw, mt, agent)[:2]
        seen.add(((rin if k == 0 else hid).size, tnn.gated(hid).size,
                  hid.size))
    assert seen == kblock.INSTANCES


@pytest.mark.parametrize("case", FLAX_BLOCKS,
                         ids=lambda c: "-".join(map(str, c)))
def test_block_twins_match_flax(case):
    """One ``EMLPBlock`` at full width through ``block_apply`` (the twins
    under autograd) vs flax: ``h`` and ``jax.vjp`` with respect to x,
    kernel, bias and bi_params, float64."""
    kind, fw, mt, agent, k = case
    jrin, jhid = _reps(jzoo, JConfig(), kind, fw, mt, agent)[:2]
    trin, thid = _reps(tzoo, TConfig(), kind, fw, mt, agent)[:2]
    jin, tin = (jrin, trin) if k == 0 else (jhid, thid)
    rng = np.random.default_rng(40 + agent)
    x = rng.normal(0, 0.7, (24, jin.size))
    g_out = rng.normal(size=(24, jhid.size))
    blk = jnn.EMLPBlock(jin, jhid)
    params = blk.init(jax.random.PRNGKey(7), jnp.zeros((1, jin.size)))
    params = jax.tree.map(lambda a: a.astype(jnp.float64), params)
    h, vjp = jax.vjp(lambda p, xx: blk.apply(p, xx), params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g_out))

    tblk = tnn.EMLPBlock(tin, thid, device="cpu", dtype=torch.float64)
    p = params["params"]
    leaves = {n: _t(a).requires_grad_(True) for n, a in (
        ("kernel", p["linear"]["kernel"]), ("bias", p["linear"]["bias"]),
        ("bi_params", p["bilinear"]["bi_params"]))}
    xt = _t(x).requires_grad_(True)
    W, b = tnn.project_linear(tin, tnn.gated(thid), leaves["kernel"],
                              leaves["bias"])
    v = tnn.bilinear_sparse(tblk.bilinear.rep, leaves["bi_params"])[3]
    spec = kblock.block_spec(tblk, "cpu")
    ht = kblock.block_apply(spec, xt, W, b, v)
    ht.backward(_t(g_out))
    _close(ht.detach().numpy(), h, 1e-9, "h")
    _close(xt.grad.numpy(), gx, 1e-9, "grad x")
    for name, ref in (("kernel", gp["params"]["linear"]["kernel"]),
                      ("bias", gp["params"]["linear"]["bias"]),
                      ("bi_params", gp["params"]["bilinear"]["bi_params"])):
        _close(leaves[name].grad.numpy(), ref, 1e-9, f"grad {name}")


# ---------------------------------------------------------------------------
# The forward without residuals
# ---------------------------------------------------------------------------
def test_forward_saves_nothing_when_autograd_records_nothing(monkeypatch):
    """``block_apply`` runs the forward without ``lin``/``pre`` under
    ``torch.no_grad()`` and when no input needs a gradient, and with them
    (under ``EMLPBlockFn``) otherwise; ``h`` is the same either way."""
    spec = _spec((62, 71, 62))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(9, 62, generator=gen)
    W = 0.2 * torch.randn(71, 62, generator=gen)
    b = 0.1 * torch.randn(71, generator=gen)
    v = 0.3 * torch.randn(spec.nnz, generator=gen)
    calls = []
    real = kblock.emlp_block

    def spy(spec, x, W, b, v, save=True):
        out = real(spec, x, W, b, v, save)
        calls.append((save, out[1] is None and out[2] is None))
        return out
    monkeypatch.setattr(kblock, "emlp_block", spy)
    with torch.no_grad():
        h0 = kblock.block_apply(spec, x, W, b, v.requires_grad_(True))
    h1 = kblock.block_apply(spec, x, W, b, v.detach())
    assert calls == [(False, True), (False, True)]
    assert h0.grad_fn is None and h1.grad_fn is None
    xg = x.clone().requires_grad_(True)
    h2 = kblock.block_apply(spec, xg, W, b, v.detach())
    assert calls[-1] == (True, False)
    assert len(h2.grad_fn.saved_tensors) == 5
    assert torch.equal(h0, h1) and torch.equal(h0, h2.detach())
    h2.sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
