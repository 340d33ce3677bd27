"""K2 sample writing the learners' operands (``kernels/replay.py``
``GatherLayout``, ``replay_sample`` and its plain twin ``replay_sample_plain``;
``algos/replay.py`` ``sample`` and ``learner_operands``) against what the
port's sample returned before it wrote operands: the ring rows' columns,
sliced into per-agent fields (``_split`` of ``data[idx]``, the fields of
``gym_rotor_tpu/algos/replay.py:199`` ``sample``, held to JAX bitwise in
``test_torch_replay.py``), and the concatenations the learners built from
them.  Everything here is a copy, so everything is compared bitwise: the
operands, the ``Batch``'s views of them, an empty ring's NaN poison, the
CUDA kernel's index arithmetic emulated on the CPU from the layout's
column map, and one TD3 and one SAC update (DTDE and CTDE, EMLP and MLP
networks, float64 and float32) on the sampled operands against the same
update on a ``Batch`` built from the fields, which concatenates them as the
learners did before.
"""
import copy

import numpy as np
import pytest
import torch

from gym_rotor_tpu_torch import Config
from gym_rotor_tpu_torch.algos import replay as R
from gym_rotor_tpu_torch.algos import sac as tsac
from gym_rotor_tpu_torch.algos import td3 as ttd3
from gym_rotor_tpu_torch.envs import draws as D
from gym_rotor_tpu_torch.kernels import replay as K

torch.set_num_threads(1)

NARROW = dict(critic_hidden_dim=8, actor_hidden_dim=(8, 4), batch_size=16)
FRAMEWORKS = {"MODUL": ((15, 3), (4, 1)), "MONO": ((23,), (4,))}
STACKS = {"plain": R.PLAIN_STACK, "td3": ttd3.CAPS_STACK,
          "sac": tsac.caps_stack(False), "sac_ctde": tsac.caps_stack(True)}
LAYOUTS = [(fw, ctde, name) for fw in FRAMEWORKS for ctde in (False, True)
           for name in STACKS if not (ctde and fw == "MONO")]


def _bits(x):
    return x.contiguous().numpy().tobytes()


def _same(xs, ys):
    return len(xs) == len(ys) and all(
        x.shape == y.shape and x.dtype == y.dtype and _bits(x) == _bits(y)
        for x, y in zip(xs, ys))


def _ring(dims, dtype, seed=0, cap=90):
    g = torch.Generator().manual_seed(seed)
    ring = torch.randn(cap, R.row_dim(*dims), generator=g, dtype=dtype)
    idx = torch.randint(0, cap, (16,), generator=g)
    return R.ReplayState(data=ring, ptr=0, filled=cap, dims=dims), idx


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("fw,ctde,name", LAYOUTS)
def test_sample_operands_match_the_fields(fw, ctde, name, dtype):
    """The sample's fields bitwise the parent's ``_split`` of the gathered
    rows, and each agent's operands bitwise the concatenations the
    learners built from them (``learner_operands`` of a ``Batch`` without
    operands); the fields are views of the one buffer, obs and next_obs
    contiguous row blocks of the stack."""
    dims = FRAMEWORKS[fw]
    stack = STACKS[name]
    rs, idx = _ring(dims, dtype)
    batch = R.sample(rs, 16, idx=idx, ctde=ctde, stack=stack)
    old = R.Batch(*R._split(rs.data[idx], dims))
    assert _same([t for f in batch[:5] for t in f],
                 [t for f in old[:5] for t in f])
    base = batch.ops.stack[0]._base
    for f in batch[:5]:
        for t in f:
            assert t._base is base
    for i in range(len(dims[0])):
        assert batch.obs[i].is_contiguous()
        assert batch.next_obs[i].is_contiguous()
        got = R.learner_operands(batch, i, ctde, stack)
        ref = R.learner_operands(old, i, ctde, stack)
        assert _same([got[0]], [ref[0]])
        assert (got[1] is None) == (not ctde)
        if ctde:
            assert _same([got[1]], [ref[1]])
        nb = 16
        keep = [q for q, f in enumerate(stack) if f != "eps"]
        assert _same([got[2][q * nb:(q + 1) * nb] for q in keep],
                     [ref[2][q * nb:(q + 1) * nb] for q in keep])


@pytest.mark.parametrize("fw,ctde,name", LAYOUTS)
def test_layout_regions_and_column_map(fw, ctde, name):
    """Every buffer float outside the ``"eps"`` blocks is written by
    exactly one region; the column map's words decode to the regions; and
    the kernel's arithmetic (element e -> (row e / W, column e % W), its
    word, the buffer index ``dst B + b w + c``) emulated on the CPU writes
    the twin's buffer bitwise."""
    dims = FRAMEWORKS[fw]
    stack = STACKS[name]
    lay = R.gather_layout(dims, ctde, stack)
    B = 16
    count = torch.zeros(B * lay.per_row, dtype=torch.int64)
    for v in lay.written(count, B):
        v += 1
    free = sum(lay.operands[f"stack{a}"][2] for a in range(len(dims[0]))) \
        * stack.count("eps") * B
    assert int((count == 1).sum()) == B * lay.gathered
    assert int((count == 0).sum()) == free and int(count.max()) == 1
    words = torch.from_numpy(lay.words())
    assert words.shape == (lay.gathered,)
    rs, idx = _ring(dims, torch.float32, seed=1)
    e = torch.arange(B * lay.gathered)
    b, j = e // lay.gathered, e % lay.gathered
    wd = words[j]
    src, dst = wd & 0xFFFF, (wd >> 16) & 0xFFFF
    w, c = (wd >> 32) & 0xFFFF, wd >> 48
    out = torch.full((B * lay.per_row,), float("nan"))
    out[dst * B + b * w + c] = rs.data[idx[b], src]
    ref = K.replay_sample_plain(rs.data, idx, False, lay)
    assert _same(lay.written(out, B), lay.written(ref, B))


@pytest.mark.parametrize("fw,ctde,name", LAYOUTS)
def test_empty_ring_sample_is_poisoned(fw, ctde, name):
    """A sample of an empty ring is NaN in every field and operand, in
    every layout."""
    dims = FRAMEWORKS[fw]
    batch = R.sample(R.create(8, *dims, device="cpu"), 4,
                     generator=torch.Generator().manual_seed(0), ctde=ctde,
                     stack=STACKS[name])
    ts = [t for f in batch[:5] for t in f] + list(batch.ops.sa)
    ts += [batch.ops.t_obs] if ctde else []
    assert all(bool(torch.isnan(t).all()) for t in ts)


@pytest.mark.parametrize("ask", ["ctde", "dtde", "stack"])
def test_learner_operands_refuse_another_layout(ask):
    """A sampled ``Batch`` read with another CTDE flag or CAPS stack than
    the sample wrote raises (a learner wired to the wrong layout fails,
    where it would otherwise concatenate copies); the same fields in a
    ``Batch`` built by hand are concatenated."""
    dims = FRAMEWORKS["MODUL"]
    rs, idx = _ring(dims, torch.float32)
    wrote = dict(ctde=ask == "dtde", stack=ttd3.CAPS_STACK)
    batch = R.sample(rs, 16, idx=idx, **wrote)
    asks = {"ctde": (True, ttd3.CAPS_STACK), "dtde": (False, ttd3.CAPS_STACK),
            "stack": (False, STACKS["sac"])}[ask]
    with pytest.raises(ValueError, match="layout"):
        R.learner_operands(batch, 0, *asks)
    sa, t_obs, stk = R.learner_operands(R.Batch(*batch[:5]), 0, *asks)
    assert sa.shape[0] == 16 and stk.shape[0] == 16 * len(asks[1])
    assert (t_obs is None) == (not asks[0])


def _learner(algo, fw, ctde, equiv, dtype):
    kw = dict(NARROW, rl_algo=algo, framework=fw, use_equiv=equiv)
    if ctde:
        kw["module_training"] = "CTDE"
    cfg = Config(**kw)
    lib = tsac if algo == "SAC" else ttd3
    Agent = tsac.SACAgent if algo == "SAC" else ttd3.TD3Agent
    agents = [Agent(cfg, i, "cpu", dtype) for i in range(cfg.n_agents)]
    g = torch.Generator().manual_seed(5)
    states = [a.init(g) for a in agents]
    return cfg, lib, agents, states


UPDATES = [(algo, fw, ctde, equiv) for algo in ("TD3", "SAC")
           for fw, ctde in (("MODUL", False), ("MODUL", True),
                            ("MONO", False))
           for equiv in (True, False)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("algo,fw,ctde,equiv", UPDATES)
def test_update_on_sampled_operands_is_bitwise(algo, fw, ctde, equiv,
                                               dtype):
    """Three updates (TD3's delayed actor step taken on the third) on
    the sampled operands and the same updates on ``Batch``es of the
    fields alone (``_split`` of the gathered rows, as the sample returned
    them before): every parameter, target, optimizer moment and loss
    bitwise."""
    cfg, lib, agents, states = _learner(algo, fw, ctde, equiv, dtype)
    twins = copy.deepcopy(states)
    dims = (tuple(cfg.obs_dim_n), tuple(cfg.action_dim_n))
    stack = tsac.caps_stack(ctde) if algo == "SAC" else ttd3.CAPS_STACK
    draws_fn = D.make_sac_update_draws if algo == "SAC" \
        else D.make_update_draws
    g = torch.Generator().manual_seed(7)
    for step in range(cfg.policy_update_freq):
        rs, idx = _ring(dims, dtype, seed=10 + step)
        ud = draws_fn(cfg.batch_size, rs.filled, cfg.obs_dim_n,
                      cfg.action_dim_n, [a.critic_widths for a in agents],
                      [a.actor_widths for a in agents], g, "cpu", dtype,
                      ctde=ctde)
        batch = R.sample(rs, cfg.batch_size, idx=idx, ctde=ctde, stack=stack)
        old = R.Batch(*R._split(rs.data[idx], dims))
        for a, st in zip(agents, states):
            a.bind(st)
        _, m1 = lib.train_step(cfg, agents, states, batch, ud.agents)
        for a, st in zip(agents, twins):
            a.bind(st)
        _, m2 = lib.train_step(cfg, agents, twins, old, ud.agents)
        assert _same(list(m1.values()), list(m2.values())), step
    for s1, s2 in zip(states, twins):
        vecs = [s1.actor, s1.critic, s1.critic_target, s1.actor_opt.mu,
                s1.actor_opt.nu, s1.critic_opt.mu, s1.critic_opt.nu]
        ref = [s2.actor, s2.critic, s2.critic_target, s2.actor_opt.mu,
               s2.actor_opt.nu, s2.critic_opt.mu, s2.critic_opt.nu]
        if algo == "TD3":
            vecs.append(s1.actor_target)
            ref.append(s2.actor_target)
        assert _same(vecs, ref)
        assert s1.total_it == s2.total_it == cfg.policy_update_freq
