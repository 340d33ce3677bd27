"""The run-time K3/K4 plans and index (``kernels/emlp_block.py``: ``rt_plan``,
``rt_words``, ``rt_smem``; ``csrc/emlp_block.cu`` "run-time widths") on the
CPU: decoded as the kernels read them and run in float64 numpy in the
kernels' traversal (block columns, each warp's runs of coordinates, rows a
lane, the parameter sums' 32-row tile partials into slot ``k % 8``, the
slots in order) against the twins, at every phase-26 shape and at the
general EMLP's SO(3) and S(4) blocks (phase 28); every coordinate,
nonzero, list entry and parameter covered once; the staged bytes and the
scratch within their bounds; and g_v's float32 order bit for bit the
instances' finishing order.  No JAX program runs here."""
import types

import numpy as np
import pytest
import torch

from gym_rotor_tpu_torch.kernels import emlp_block as KB
from gym_rotor_tpu_torch.models.emlp import general_nn as GN
from gym_rotor_tpu_torch.models.emlp import groups as GG
from gym_rotor_tpu_torch.models.emlp import nn as tnn
from gym_rotor_tpu_torch.models.emlp import zoo as tzoo
from gym_rotor_tpu_torch.models.emlp.rep_algebra import V
from gym_rotor_tpu_torch.utils.config import Config

SMS = 132                                  # an H100's SMs
PHASE_ROWS = (1, 31, 32, 33, 256, 768, 3723, 4096)
WIDTHS = (((8, 4), 8), ((32, 8), 128), ((64, 16), 256))
WIDE_CRITIC = 512
GENERAL_CH = 384


def _phase26_specs():
    """``{dims: BlockSpec}`` of phase 26's blocks on the CPU, from the
    networks' reps: the TD3 twin critics' (obs + action in), the actors'
    and the PPO V critics' (obs in) first and hidden blocks at each width,
    and critic 512's hidden blocks."""
    specs = {}
    for ah, ch in WIDTHS:
        cfg = Config(actor_hidden_dim=ah, critic_hidden_dim=ch)
        for i in range(cfg.n_agents):
            for reps in (tzoo.critic_reps(cfg, "MODUL", i, "DTDE"),
                         tzoo.actor_reps(cfg, "MODUL", i),
                         tzoo.v_critic_reps(cfg, "MODUL", i, "DTDE")):
                rin, hid = reps[0], reps[1]
                for a, b in ((rin, hid), (hid, hid)):
                    spec = KB.BlockSpec(a, b, tnn.gated(b), "cpu")
                    specs.setdefault(spec.dims, spec)
    for i in (0, 1):
        hid = tzoo.critic_reps(Config(critic_hidden_dim=WIDE_CRITIC),
                               "MODUL", i, "DTDE")[1]
        spec = KB.BlockSpec(hid, hid, tnn.gated(hid), "cpu")
        specs.setdefault(spec.dims, spec)
    return specs


def _general_specs():
    """The general EMLP's distinct blocks at ``ch`` 384 (phase 28's
    ``GeneralEMLP(V -> V)``): the first and the hidden block over SO(3)
    and over S(4), their index only (no linear bases solved)."""
    specs = {}
    for grp, n in (("SO", 3), ("S", 4)):
        G = getattr(GG, grp)(n)
        mid = GN.uniform_rep(GENERAL_CH, G)
        for i, ra in enumerate((V(G), mid)):
            blk = types.SimpleNamespace(rep_in=ra, rep_out=mid,
                                        grep=GN.gated(mid))
            specs[f"{grp}{n}-{i}"] = KB.general_block_spec(blk, "cpu")
    return specs


@pytest.fixture(scope="module")
def all_specs():
    specs = {str(d): s for d, s in _phase26_specs().items()}
    specs.update(_general_specs())
    return specs


def test_the_shapes_include_the_widest_blocks(all_specs):
    """Critic 256's hidden blocks, critic 512's (staged forward, backward
    from global memory) and the general SO(3) and S(4) blocks."""
    dims = {s.dims for s in all_specs.values()}
    for d in ((256, 288, 256), (256, 511, 256), (512, 1023, 512),
              (384, 432, 384), (3, 432, 384), (384, 384, 384),
              (4, 384, 384)):
        assert d in dims, d
    assert all_specs["SO3-1"].nnz == 461520
    assert all_specs["S4-1"].nnz == 272384


def _decode_words(spec, rows, staged):
    """``rt_words`` split and unpacked into coordinates: the forward's
    (j, i), the lists' (o, partner)."""
    w = spec.rt_words(rows, staged).numpy().view(np.uint32).astype(np.int64)
    pitch = 32 * rows + 1 if staged else 1
    hi, lo = w >> 16, w & 0xffff
    assert np.all(hi % pitch == 0) and np.all(lo % pitch == 0)
    hi, lo = hi // pitch, lo // pitch
    n = spec.nnz
    return (hi[:n], lo[:n]), (hi[n:], lo[n:])


@pytest.mark.parametrize("layout", ((1, True), (2, True), (1, False)),
                         ids=("staged1", "staged2", "global"))
def test_rt_words_unpack_to_the_index(all_specs, layout):
    """Every packed word decodes to its nonzero's (j, i) and its list
    entry's (o, partner) (``BlockSpec.idx``, ``coordinate_lists``), staged
    as tile offsets ``c (32 R + 1)``, from global memory as coordinates
    (each staged layout at the shapes whose forward tile fits it)."""
    rows, staged = layout
    for name, spec in all_specs.items():
        if staged and KB.rt_smem(spec.dims, "forward", rows) > KB.SMEM_LIMIT:
            continue
        (j, i), (o, p) = _decode_words(spec, *layout)
        np.testing.assert_array_equal(j, spec.idx["j"].numpy(), name)
        np.testing.assert_array_equal(i, spec.idx["i"].numpy(), name)
        _, _, lo, partner = spec.lists
        np.testing.assert_array_equal(o, lo, name)
        np.testing.assert_array_equal(p, partner, name)


def _fwd_runs(plan):
    """Per column (k0, k1, q0, q1) and the warps' coordinate lists."""
    out = []
    for row in plan.numpy().astype(np.int64):
        k0, k1, q0, q1 = row[:4]
        warps = []
        for w in range(KB.RT_WARPS):
            a0, a1, b0, b1 = row[4 + 4 * w:8 + 4 * w]
            assert k0 <= a0 <= a1 <= k1 and q0 <= b0 <= b1 <= q1
            warps.append(list(range(a0, a1)) + list(range(b0, b1)))
        out.append(((k0, k1, q0, q1), warps))
    return out


def _bwd_runs(plan):
    """Per column (v0, v1, c0, c1, g0, g1) and the warps' segment lists."""
    out = []
    for row in plan.numpy().astype(np.int64):
        warps = [list(range(row[6 + 2 * w], row[7 + 2 * w]))
                 for w in range(KB.RT_WARPS)]
        out.append((tuple(row[:6]), warps))
    return out


def _slot_events(B, rows, groups):
    """The list step's (and rt_gw_kernel's) walk over the 32-row tiles:
    block ``u`` of the ``groups`` slot groups takes the tiles of ``32 R``
    rows ``u, u + groups, ...`` in order, each its ``R`` 32-row tiles; the
    (slot, 32-row tile) pairs in the order one slot sees them."""
    n32 = -(-B // 32)
    by_slot = {}
    tiles = -(-B // (32 * rows))
    for u in range(groups):
        for t in range(u, tiles, groups):
            for k in range(rows):
                k32 = t * rows + k
                if k32 < n32:
                    by_slot.setdefault(k32 % KB.RT_SLOTS, []).append(k32)
    return by_slot


def test_rt_plans_cover_everything_once(all_specs):
    """At every shape and row count: the forward's columns take whole
    atoms (each output once, its gate coordinate in its column), its warps
    every coordinate once; the list step's warps every coordinate once,
    its columns every nonzero's g_v once; the slot walk puts 32-row tile
    k into slot k % 8 once, in increasing order; the grids stay within
    one wave of the blocks the SMs hold; the staged bytes fit a block."""
    for name, spec in sorted(all_specs.items()):
        ng, nh = spec.ng, spec.nh
        for B in PHASE_ROWS:
            plan, cols, rows, staged, _ = spec.rt_plan("forward", B, SMS)
            runs = _fwd_runs(plan)
            assert len(runs) == cols == plan.shape[0]
            assert plan.shape[1] == 4 + 4 * KB.RT_WARPS
            seen_c, seen_k = np.zeros(ng, int), np.zeros(nh, int)
            for (k0, k1, q0, q1), warps in runs:
                seen_k[k0:k1] += 1
                g = spec.gate[k0:k1]
                assert np.all((g == np.arange(k0, k1))
                              | ((g >= q0) & (g < q1))), name
                for w in warps:
                    seen_c[w] += 1
            np.testing.assert_array_equal(seen_c, 1, f"{name} {B}")
            np.testing.assert_array_equal(seen_k, 1, f"{name} {B}")
            smem = KB.rt_smem(spec.dims, "forward", rows if staged else 0)
            assert smem <= KB.SMEM_LIMIT
            tiles = -(-B // (32 * rows))
            assert tiles * cols <= max(
                tiles, 1.5 * SMS * KB.rt_blocks_per_sm(smem))

            plan, cols, rows, staged, most = spec.rt_plan("backward", B,
                                                          SMS)
            runs = _bwd_runs(plan)
            assert plan.shape == (cols, 6 + 2 * KB.RT_WARPS)
            seg, cseg = KB.rt_segments(spec.lists[0])
            seen_c, seen_v = np.zeros(ng, int), np.zeros(spec.nnz, int)
            seen_s = np.zeros(len(seg) - 1, int)
            for (v0, v1, c0, c1, g0, g1), warps in runs:
                seen_v[v0:v1] += 1
                seen_c[c0:c1] += 1
                assert (g0, g1) == (cseg[c0], cseg[c1])
                assert g1 - g0 <= most
                for w in warps:
                    assert all(g0 <= s_ < g1 for s_ in w)
                    seen_s[w] += 1
            np.testing.assert_array_equal(seen_c, 1, f"{name} {B}")
            np.testing.assert_array_equal(seen_v, 1, f"{name} {B}")
            np.testing.assert_array_equal(seen_s, 1, f"{name} {B}")
            smem = KB.rt_smem(spec.dims, "backward", rows if staged else 0,
                              most)
            assert smem <= KB.SMEM_LIMIT
            tiles = -(-B // (32 * rows))
            groups = min(KB.RT_SLOTS // rows, tiles)
            assert groups * cols <= max(groups, SMS * KB.rt_blocks_per_sm(
                KB.rt_smem(spec.dims, "backward", rows if staged else 0)))
            by_slot = _slot_events(B, rows, groups)
            flat = sorted(k for ks in by_slot.values() for k in ks)
            assert flat == list(range(-(-B // 32)))
            for s, ks in by_slot.items():
                assert ks == sorted(ks) and all(k % 8 == s for k in ks)
            # two rows a lane only where a block of two fits, and from
            # RT_TWO_ROWS_MIN rows
            if rows == 2:
                assert staged and B >= KB.RT_TWO_ROWS_MIN


def test_rt_layouts_at_the_widest_shapes(all_specs):
    """The layouts the plans take at the widest shapes: the
    SO(3) general block stages both steps (two rows a lane forward, one
    backward: two tiles of 65-float rows would pass 227 KB), S(4) two rows
    forward and one backward (its segments' shares beside two rows' tiles
    would not fit); critic 512's Mirror block reads its backward tile from
    global memory; the critic blocks at 256 rows one row a lane, and
    forced to two the steps ``chip_smoke.py`` phase 26 expects."""
    so3, s4 = all_specs["SO3-1"], all_specs["S4-1"]
    lay = lambda sp, k, B: tuple(sp.rt_plan(k, B, SMS)[2:4])
    assert lay(so3, "forward", 4096) == (2, True)
    assert lay(so3, "backward", 4096) == (1, True)
    assert KB.rt_smem(so3.dims, "backward", 2) > KB.SMEM_LIMIT
    assert lay(s4, "forward", 4096) == (2, True)
    assert lay(s4, "backward", 4096) == (1, True)
    wide = all_specs[str((512, 1023, 512))]
    assert lay(wide, "forward", 256) == (1, True)
    assert lay(wide, "backward", 256) == (1, False)
    for d in ((256, 288, 256), (256, 511, 256)):
        assert lay(all_specs[str(d)], "backward", 256)[0] == 1
    # two rows a lane forced at 256 rows (phase 26's two-rows check): the
    # forward at both critic-256 blocks, the list step at 288 only
    forced = {d: [k for k in ("forward", "backward")
                  if _two_rows_fit(all_specs[str(d)], k, 256)]
              for d in ((256, 288, 256), (256, 511, 256))}
    assert forced == {(256, 288, 256): ["forward", "backward"],
                      (256, 511, 256): ["forward"]}


def test_rt_scratch_is_eight_slots(all_specs):
    """The parameter sums' scratch: ``RT_SLOTS`` (8) slots of ``n_par``
    floats, 20.1 MB at the SO(3) general block (627 840 parameters), where
    one partial a 32-row tile would take 321 MB at 4096 rows."""
    so3 = all_specs["SO3-1"]
    n_par = so3.ng * so3.nin + so3.ng + so3.nnz
    assert n_par == 627840
    assert KB.RT_SLOTS * n_par * 4 == 20090880
    assert (4096 // 32) * n_par * 4 == 321454080


def rt_emulate(spec, x, W, b, v, g_h, rows_force=(), stage_force=None):
    """The run-time kernels in float64 numpy as they traverse their plans
    at ``B = len(x)`` rows on ``SMS`` SMs: lin; per forward column and
    warp, each coordinate's nonzeros (decoded from ``rt_words``) for pre,
    then h for the column's outputs; g_pre; per list column and warp, each
    segment's list entries, then each coordinate's g_pre and its segments'
    shares for g_lin; g_x; the parameter sums as 32-row
    tile partials, added into slot k % 8 in the order the list step's and
    rt_gw_kernel's blocks walk the tiles, then the slots in order.  Every
    value written is checked written once."""
    force = {f"{kind}_rows": 2 for kind in rows_force}
    if stage_force is not None:
        force.update(forward=stage_force, backward=stage_force)
    KB._FORCE.update(force)
    try:
        fplan, _, frows, fstaged, _ = spec.rt_plan("forward", len(x), SMS)
        bplan, _, brows, bstaged, _ = spec.rt_plan("backward", len(x), SMS)
        (j, i), _ = _decode_words(spec, frows, fstaged)
        _, (lo, partner) = _decode_words(spec, brows, bstaged)
    finally:
        for k in force:
            KB._FORCE.pop(k)
    B = len(x)
    rp = spec.rowptr
    lin = x @ W.T + b                                  # (B, ng)
    pre = np.full_like(lin, np.nan)
    h = np.full((B, spec.nh), np.nan)
    for (k0, k1, q0, q1), warps in _fwd_runs(fplan):
        for w in warps:
            for c in w:
                e = np.arange(rp[c], rp[c + 1])
                q = (v[e] * lin[:, j[e]] * lin[:, i[e]]).sum(1)
                assert np.isnan(pre[:, c]).all()
                pre[:, c] = 0.1 * q + lin[:, c]
        for k in range(k0, k1):
            h[:, k] = pre[:, k] / (1 + np.exp(-pre[:, spec.gate[k]]))
    gpre = np.zeros_like(pre)
    ginv_ptr, ginv_k = spec.ginv
    for c in range(spec.ng):
        if c < spec.nh:
            gpre[:, c] = g_h[:, c] / (1 + np.exp(-pre[:, spec.gate[c]]))
        s = 1 / (1 + np.exp(-pre[:, c]))
        for k in ginv_k[ginv_ptr[c]:ginv_ptr[c + 1]]:
            gpre[:, c] += g_h[:, k] * pre[:, k] * s * (1 - s)
    cl_ptr, cl_e = spec.lists[0], spec.lists[1]
    glin = np.full_like(gpre, np.nan)
    slots = np.full((KB.RT_SLOTS, spec.ng * spec.nin + spec.ng + spec.nnz),
                    np.nan)
    nw = spec.ng * spec.nin
    groups = min(KB.RT_SLOTS // brows, -(-B // (32 * brows)))
    by_slot = _slot_events(B, brows, groups)
    o, jj, ii = (spec.idx[k].numpy() for k in ("o", "j", "i"))
    seg, cseg = KB.rt_segments(cl_ptr)
    for (v0, v1, c0, c1, g0, g1), warps in _bwd_runs(bplan):
        share = {}
        for w in warps:
            for s_ in w:
                e = np.arange(seg[s_], seg[s_ + 1])
                assert s_ not in share
                share[s_] = 0.1 * (v[cl_e[e]] * gpre[:, lo[e]]
                                   * lin[:, partner[e]]).sum(1)
        for c in range(c0, c1):
            assert np.isnan(glin[:, c]).all()
            glin[:, c] = gpre[:, c] + sum(
                (share[s_] for s_ in range(cseg[c], cseg[c + 1])), 0.0)
        es = np.arange(v0, v1)
        for s, ks in by_slot.items():
            assert np.isnan(slots[s, nw + spec.ng + es]).all()
            tot = 0.0
            for k in ks:
                r = slice(32 * k, 32 * k + 32)
                tot = tot + (0.1 * gpre[r, o[es]] * lin[r, jj[es]]
                             * lin[r, ii[es]]).sum(0)
            slots[s, nw + spec.ng + es] = tot
    xa = np.concatenate([x, np.ones((B, 1))], 1)
    for s, ks in by_slot.items():
        tot = 0.0
        for k in ks:
            r = slice(32 * k, 32 * k + 32)
            tot = tot + glin[r].T @ xa[r]                  # (ng, nin + 1)
        slots[s, :nw] = tot[:, :spec.nin].reshape(-1)
        slots[s, nw:nw + spec.ng] = tot[:, spec.nin]
    used = sorted(by_slot)
    assert used == list(range(len(used)))
    g_par = slots[used].sum(0)
    assert not np.isnan(g_par).any()
    return (h, lin.T, pre.T), (glin @ W, g_par[:nw].reshape(spec.ng, -1),
                              g_par[nw:nw + spec.ng], g_par[nw + spec.ng:])


def _operands(spec, B, seed):
    rng = np.random.default_rng(seed)
    per = max(1.0, spec.nnz / spec.ng)
    return (rng.normal(size=(B, spec.nin)),
            rng.normal(size=(spec.ng, spec.nin)) / np.sqrt(spec.nin),
            rng.normal(size=spec.ng) * 0.1,
            rng.normal(size=spec.nnz) * 0.5 / np.sqrt(per),
            rng.normal(size=(B, spec.nh)))


def _vs_twins(spec, B, seed, **force):
    x, W, b, v, g_h = _operands(spec, B, seed)
    fwd, bwd = rt_emulate(spec, x, W, b, v, g_h, **force)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    tf = KB.emlp_block_plain(spec, t(x), t(W), t(b), t(v))
    tb = KB.emlp_block_backward_plain(spec, t(g_h), t(x), t(W), t(v),
                                      tf[1], tf[2], True)
    for name, got, ref in zip(("h", "lin", "pre", "g_x", "g_W", "g_b",
                               "g_v"), fwd + bwd, tf + tb):
        ref = ref.numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * max(
            1.0, np.abs(ref).max()), err_msg=f"{spec.dims} {B} {name}")


def _two_rows_fit(spec, kind, B):
    """Whether ``kind``'s plan at ``B`` rows takes two rows a lane when
    forced (its tiles and, for the list step, its segments' shares fit)."""
    KB._FORCE[kind + "_rows"] = 2
    try:
        return spec.rt_plan(kind, B, SMS).rows == 2
    except ValueError:
        return False
    finally:
        KB._FORCE.pop(kind + "_rows")


def _layouts(spec, B=264):
    """The natural layout and two rows a lane in each step whose plan fits
    them."""
    two = tuple(k for k in ("forward", "backward")
                if _two_rows_fit(spec, k, B))
    return ({}, {"rows_force": two}) if two else ({},)


@pytest.mark.parametrize("dims", ((19, 9, 8), (8, 15, 8), (62, 71, 62),
                                  (256, 288, 256), (15, 288, 256),
                                  (256, 511, 256), (512, 1023, 512)),
                         ids=str)
def test_rt_emulation_matches_twins(all_specs, dims):
    """Each phase-26 shape's kernels in their traversal (``rt_emulate``)
    against the twins within 1e-12 (float64), one row a lane and, where
    the plan fits them, two (forced, as from ``RT_TWO_ROWS_MIN`` rows): at
    264 rows (nine 32-row tiles: slot 0 takes two) below 100 coordinates,
    at 72 rows (three tiles) at the wide shapes."""
    spec = all_specs.get(str(dims)) or KB.block_spec(tnn.EMLPBlock(
        *([tzoo.critic_reps(Config(), "MODUL", 0, "DTDE")[1]] * 2),
        device="cpu"), "cpu")
    B = 264 if spec.ng < 100 else 72
    for force in _layouts(spec, B):
        _vs_twins(spec, B, sum(dims), **force)


@pytest.mark.parametrize("name", ("SO3-0", "SO3-1", "S4-0", "S4-1"))
def test_rt_emulation_matches_twins_general(all_specs, name):
    """The general EMLP's blocks at ``ch`` 384 in the kernels' traversal
    against the twins within 1e-12, at 40 rows with two rows a lane in each
    step whose plan fits them (forced; one row a lane and the slots' wrap
    are the phase-26 shapes' cases): their long lists cut into segments
    over the warps."""
    spec = all_specs[name]
    _vs_twins(spec, 40, 7, **_layouts(spec, 40)[-1])


@pytest.mark.parametrize("force", ({"rows_force": ("forward", "backward")},
                                   {"stage_force": False}),
                         ids=("two_rows", "global"))
def test_rt_forced_layouts_match_twins(all_specs, force):
    """The layouts phase 26 forces for its bitwise checks (two rows a
    lane, the tile from global memory) traverse to the twins as well."""
    spec = all_specs[str((256, 288, 256))]
    _vs_twins(spec, 100, 3, **force)


def _gv_order_f32(spec, B, seed, events):
    """g_v in float32 in a given order: each 32-row tile's partial rows in
    order (``s += 0.1 g_pre[o] lin[j] lin[i]``), the tiles added into
    their slots in ``events``' order from zero, then the 8 slots in order
    (an unused slot adding zero)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    gp = rng.normal(size=(B, spec.ng)).astype(f)
    ln = rng.normal(size=(B, spec.ng)).astype(f)
    o, j, i = (spec.idx[k].numpy() for k in ("o", "j", "i"))
    sums = [np.zeros(spec.nnz, f) for _ in range(KB.RT_SLOTS)]
    for s, k in events:
        p = np.zeros(spec.nnz, f)
        for r in range(32 * k, min(B, 32 * k + 32)):
            p = p + f(0.1) * gp[r, o] * ln[r, j] * ln[r, i]
        sums[s] = sums[s] + p
    tot = sums[0]
    for s in range(1, KB.RT_SLOTS):
        tot = tot + sums[s]
    return tot


def test_rt_gv_order_is_the_instances(all_specs):
    """At the flagship's default hidden block (62, 71, 62), 300 rows: g_v
    summed in float32 in the order the list step's blocks walk their
    slots (one and two rows a lane) is bit for bit g_v in the instances'
    ``block_bwd_finish_kernel`` order (tile k into sum k % 8 in tile order,
    then the 8 sums in order)."""
    spec = KB.block_spec(tnn.EMLPBlock(
        *([tzoo.critic_reps(Config(), "MODUL", 0, "DTDE")[1]] * 2),
        device="cpu"), "cpu")
    assert spec.dims == (62, 71, 62)
    B = 300
    n32 = -(-B // 32)
    inst = [(k % 8, k) for w in range(8) for k in range(w, n32, 8)]
    ref = _gv_order_f32(spec, B, 5, inst)
    for rows in (1, 2):
        groups = min(KB.RT_SLOTS // rows, -(-B // (32 * rows)))
        # the blocks run in any order; each slot's tiles come in its
        # block's order, which the instances' order must equal
        by_slot = _slot_events(B, rows, groups)
        ev = [(s, k) for s in sorted(by_slot, reverse=True)
              for k in by_slot[s]]
        got = _gv_order_f32(spec, B, 5, ev)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
