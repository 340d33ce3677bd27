"""PyTorch port vs the JAX package: the SAC learner (DTDE), on the plain
twins of K10 (squashed-Gaussian sample and log-prob, forward and backward),
K9 (the fused SAC actor's acting sample), K3/K4, K6, K7 and K2/K8.  The
CUDA kernels are held to the same twins by chip_smoke.py on the card.

Narrow widths that keep every bilinear regime, as ``test_torch_td3.py``:
critics of 8 hidden channels, actors of 8 / 4, batch 16.  Random draws are
JAX's own, rebuilt from its key chain (``sac.py:134``, ``:146``).

Tolerances.
- K10 against ``jax.vjp``.  Float64: within 1e-10 of the compared array's
  largest entry, plus, per element, 8 ulp of the intermediate terms the
  gradient is a sum of (``kernels/sac_sample.py::rounding_scales``): the
  as-written derivative carries two terms ``+-g_logp z / std`` that cancel
  in exact arithmetic (~1e9 where ``log_std`` is at its lower clip), and
  JAX's tanh rule splits ``1 - a^2`` as ``(1 - a) + (1 - a) a`` around the
  action's cotangent (~2e6 ``g_logp`` at ``a = -1``), so JAX and the port
  round them differently.  Float32: 4 ulp of the largest entry for the
  sample and log-prob, 1e-5 of it for the gradients, plus the same
  per-element allowance.  The rows keep ``|x|`` below 2.5 or at or above
  20: between the two, XLA's and torch's tanh differ by an ulp or two,
  which ``log((1 - a^2) + EPS)`` amplifies up to ~1/EPS.
- Networks and the one update, float64: within 1e-9 of the compared
  vector's largest entry (the port projects once per loss and sums in
  another order), as for TD3; the structured forward within 1e-12.
- The superstep, float32 as JAX runs it: the env state within the tick's
  float32 bounds (``test_torch_env.py``); losses within 1e-4 relative and
  parameters within 1e-4 of the largest entry, because JAX under x64 draws
  the actor loss's noise without a dtype (``sac.py:239-240``) and so runs
  the whole actor loss in float64 where the port stays in float32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from jax.flatten_util import ravel_pytree

from gym_rotor_tpu.algos import sac as jsac
from gym_rotor_tpu.models import mlp as jmlp
from gym_rotor_tpu.models import zoo as jmodels
from gym_rotor_tpu.models.emlp import zoo as jzoo
from gym_rotor_tpu_torch import Config as TConfig
from gym_rotor_tpu_torch import convert
from gym_rotor_tpu_torch.algos import sac as tsac
from gym_rotor_tpu_torch.envs import draws as D
from gym_rotor_tpu_torch.evaluate import joint_policy
from gym_rotor_tpu_torch.kernels import emlp_actor as kactor
from gym_rotor_tpu_torch.kernels import sac_sample as K10
from gym_rotor_tpu_torch.models import mlp as tmlp
from gym_rotor_tpu_torch.models.emlp import zoo as tzoo
from test_torch_td3 import (AGENTS, OffPolicy, _adam, _batch, _cfgs, _close,
                            _np, _np_tree, _schedule, _t, _to64, split_chain,
                            superstep_vs_jax)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# K10: the squashed-Gaussian sample and its log-prob
# ---------------------------------------------------------------------------
def _k10_inputs(dtype_np, act=4, seed=0):
    """Rows of four kinds, 16 each: moderate (|x| < 2.5), ``log_std`` at its
    upper clip (2) with small noise, at its lower clip (-20), and saturated
    (|x| >= 20, at both clip bounds)."""
    rng = np.random.default_rng(seed)
    n = 16
    m = rng.normal(0, 0.4, (4 * n, act))
    s = rng.uniform(-3, 0.5, (4 * n, act))
    z = np.clip(rng.normal(size=(4 * n, act)), -1.2, 1.2)
    s[n:2 * n] = 2.0
    z[n:2 * n] *= 0.2
    s[2 * n:3 * n] = -20.0
    m[3 * n:] = np.where(m[3 * n:] < 0, -30.0, 30.0)
    s[3 * n:] = np.where(rng.uniform(size=(n, act)) < 0.5, 2.0, -20.0)
    m[2 * n] = 0.0                       # x = std * n exactly
    ga = rng.normal(size=(4 * n, act))
    gl = rng.normal(size=(4 * n, 1))
    return [a.astype(dtype_np) for a in (m, s, z, ga, gl)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("act", [4, 1])
def test_sac_sample_forward_and_backward_match_jax(dtype, act):
    """``sac_sample_plain`` vs ``mlp.sac_sample_with_noise``, and the hand
    backward ``sac_sample_backward_plain`` vs ``jax.vjp`` of it, on
    moderate, clip-bound and saturated rows."""
    m, s, z, ga, gl = _k10_inputs(dtype, act)
    jd = jnp.dtype(dtype)

    def f(mm, ss):
        a, lp, _ = jmlp.sac_sample_with_noise(mm, ss, jnp.asarray(z, jd))
        return a, lp
    (ja, jl), vjp = jax.vjp(f, jnp.asarray(m), jnp.asarray(s))
    jgm, jgs = vjp((jnp.asarray(ga), jnp.asarray(gl)))
    ta, tl = K10.sac_sample_plain(_t(m), _t(s), _t(z))
    tgm, tgs = K10.sac_sample_backward_plain(_t(ga), _t(gl), _t(m), _t(s),
                                            _t(z))
    ulp = float(np.finfo(dtype).eps)
    sm, ss = (8 * ulp * _np(r) for r in K10.rounding_scales(
        _t(ga), _t(gl), _t(m), _t(s), _t(z)))
    fwd_rel, bwd_rel = (1e-10, 1e-10) if dtype == "float64" else (4 * ulp,
                                                                  1e-5)
    for name, got, ref, rel, extra in (
            ("action", ta, ja, fwd_rel, 0.0), ("logp", tl, jl, fwd_rel, 0.0),
            ("g_mean", tgm, jgm, bwd_rel, sm),
            ("g_log_std", tgs, jgs, bwd_rel, ss)):
        got, ref = _np(got).astype(np.float64), np.asarray(ref, np.float64)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        scale = np.abs(ref).max()
        err = np.abs(got - ref)
        assert (err <= rel * scale + extra).all(), (name, err.max(), scale)
    # the saturated rows really saturate: 1 - a^2 is 0 and EPS carries it
    assert (np.abs(_np(ta)[48:]) == 1.0).all()


def test_squashed_gaussian_autograd_uses_the_hand_backward():
    """``squashed_gaussian`` under autograd: forward values of
    ``sac_sample_plain``, gradients of ``sac_sample_backward_plain`` for a
    loss that uses both outputs, and no launch counted on CPU tensors."""
    m, s, z, ga, gl = _k10_inputs("float64", 4, seed=1)
    mt, st = _t(m).requires_grad_(True), _t(s).requires_grad_(True)
    before = (K10.sac_head.launches, K10.sac_head_backward.launches)
    a, lp = K10.squashed_gaussian(mt, st, _t(z))
    ((a * _t(ga)).sum() + (lp * _t(gl)).sum()).backward()
    ra, rl = K10.sac_sample_plain(_t(m), _t(s), _t(z))
    rgm, rgs = K10.sac_sample_backward_plain(_t(ga), _t(gl), _t(m), _t(s),
                                            _t(z))
    assert torch.equal(a.detach(), ra) and torch.equal(lp.detach(), rl)
    assert torch.equal(mt.grad, rgm) and torch.equal(st.grad, rgs)
    assert (K10.sac_head.launches,
            K10.sac_head_backward.launches) == before


# ---------------------------------------------------------------------------
# The SAC actor
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _flax_sac_actor(agent_id):
    jcfg, _ = _cfgs()
    mod = jzoo.sac_models(jcfg, agent_id).actor_def
    params = mod.init(jax.random.PRNGKey(7 + agent_id),
                      jnp.zeros((1, jcfg.obs_dim_n[agent_id])))
    return mod, params


@pytest.mark.parametrize("agent_id", AGENTS)
def test_sac_actor_layout_matches_flax(agent_id):
    """``EMLPActorSAC``'s parameter names, shapes and flat order equal the
    flax tree's ``ravel_pytree`` order (``log_std_linear`` first, its
    kernel ``(nin, nout)``), and the converter fills them leaf for leaf."""
    _, tcfg = _cfgs()
    agent = tsac.SACAgent(tcfg, agent_id, "cpu")
    _, params = _flax_sac_actor(agent_id)
    leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    names = [".".join(k.key for k in path) for path, _ in leaves]
    assert names == agent.actor_layout.names
    assert [tuple(v.shape) for _, v in leaves] == agent.actor_layout.shapes
    assert names[0] == "log_std_linear.bias"
    assert dict(zip(names, agent.actor_layout.shapes))[
        "log_std_linear.kernel"] == (tzoo.actor_reps(tcfg, "MODUL", agent_id)
                                     [1].size, tcfg.action_dim_n[agent_id])
    flat = convert.flat_from_jax(_np_tree(params), agent.actor_layout, "cpu")
    np.testing.assert_array_equal(_np(flat), np.asarray(ravel_pytree(params)[0]))
    sd = convert.sac_actor_params_from_jax(_np_tree(params), tcfg, agent_id)
    assert {n: tuple(v.shape) for n, v in sd.items()} == dict(
        zip(agent.actor_layout.names, agent.actor_layout.shapes))
    assert agent.actor_widths == [
        int(w.shape[1]) for w in jax.tree.leaves(
            jzoo.spectral_weights(params)[0])]


def _dist_f(agent, views, obs):
    """``(mean, log_std)`` on the training path's trunk (``trunk_f``) as
    torch ops: the heads and the clamp (``head_plain``)."""
    h, heads = agent.trunk_f(views, obs)
    return K10.head_plain(h, *heads, not agent.equivariant)


@pytest.mark.parametrize("agent_id", AGENTS)
def test_sac_actor_forward_matches_flax(agent_id):
    """``(mean, log_std)`` of flax's ``EMLPActorSAC`` with the carried
    params, float64: the structured ``dist`` within 1e-12 and the training
    path's ``dist_f`` (projection once, the block function per block)
    within 1e-9, with ``log_std`` pushed past both clip bounds on some
    rows."""
    _, tcfg = _cfgs()
    mod, params = _flax_sac_actor(agent_id)
    params = _to64(params)
    rng = np.random.default_rng(20 + agent_id)
    obs = rng.normal(0, 0.6, (24, tcfg.obs_dim_n[agent_id]))
    obs[:4] *= 40.0
    jm, jl = mod.apply(params, jnp.asarray(obs))
    actor = tzoo.EMLPActorSAC(*tzoo.actor_reps(tcfg, "MODUL", agent_id),
                              tcfg.action_dim_n[agent_id], device="cpu",
                              dtype=torch.float64)
    actor.load_state_dict(convert.sac_actor_params_from_jax(
        _np_tree(params), tcfg, agent_id))
    with torch.no_grad():
        tm, tl = actor.dist(_t(obs))
    _close(_np(tm), jm, 1e-12, "mean")
    _close(_np(tl), jl, 1e-12, "log_std")
    agent = tsac.SACAgent(tcfg, agent_id, "cpu", torch.float64)
    flat = convert.flat_from_jax(_np_tree(params), agent.actor_layout, "cpu",
                                 torch.float64)
    fm, fl = _dist_f(agent, agent.actor_layout.views(flat), _t(obs))
    _close(_np(fm), jm, 1e-9, "dist_f mean")
    _close(_np(fl), jl, 1e-9, "dist_f log_std")


@pytest.mark.parametrize("agent_id", AGENTS)
@pytest.mark.parametrize("is_eval", [False, True])
def test_acting_matches_choose_action(agent_id, is_eval):
    """The acting path (K9's plain twin through ``SACAgent.choose_action``)
    vs ``SACAgent.choose_action_f`` with JAX's own noise, float64, in train
    (``tanh(mean + std noise)``) and eval (``tanh(mean)``) modes; the
    deterministic mode is also what ``evaluate.joint_policy`` acts with."""
    jcfg, tcfg = _cfgs()
    jagent = jsac.SACAgent(jcfg, agent_id, jzoo.sac_models(jcfg, agent_id))
    _, params = _flax_sac_actor(agent_id)
    params = _to64(params)
    rng = np.random.default_rng(40 + agent_id)
    obs = rng.normal(0, 0.6, (32, tcfg.obs_dim_n[agent_id]))
    key = jax.random.PRNGKey(41)
    ref = jagent.choose_action_f(params, jnp.asarray(obs), key, is_eval)
    noise = jax.random.normal(key, ref.shape, jnp.float64)
    agent = tsac.SACAgent(tcfg, agent_id, "cpu", torch.float64)
    flat = convert.flat_from_jax(_np_tree(params), agent.actor_layout, "cpu",
                                 torch.float64)
    st = agent.make_state(flat, torch.zeros(agent.critic_layout.size))
    before = kactor.sac_actor.launches
    got = agent.choose_action(st, _t(obs), None if is_eval else _t(noise))
    _close(_np(got), ref, 1e-12, "action")
    if is_eval:
        joint = joint_policy([agent.actor_net])((_t(obs),))   # float32 out
        _close(_np(joint), ref, 1e-7, "joint_policy")
    assert kactor.sac_actor.launches == before


def test_sac_fold_packs_the_log_std_head():
    """K9's folded image holds K3's sections (blocks, mean head) and the
    log_std Dense transposed to (act, hidden) and its bias; the cache
    refolds after the flat optimizer's write bumps the version."""
    _, tcfg = _cfgs()
    agent = tsac.SACAgent(tcfg, 0, "cpu")
    st = agent.init(torch.Generator().manual_seed(2))
    actor = agent.actor_net
    f1 = kactor.fold_actor(actor)
    nin, ng, nh, nact = f1["dims"]
    assert (nin, nh, nact) == (15, tcfg.actor_hidden_dim[0], 4)
    torch.testing.assert_close(
        kactor.section(f1, "wl", nact * nh).view(nact, nh),
        actor.log_std_linear.kernel.T, rtol=0, atol=0)
    torch.testing.assert_close(kactor.section(f1, "bl", nact),
                               actor.log_std_linear.bias, rtol=0, atol=0)
    grad = torch.ones(st.actor.shape)
    st.actor_opt = agent.actor_tx.update(st.actor, grad, st.actor_opt,
                                         owner=actor)
    assert kactor.fold_actor(actor) is not f1


# ---------------------------------------------------------------------------
# One update
# ---------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _sac_draw_arrays(key, shapes, jdtype, joint):
    """``train_step``'s draws from its key (sac.py:134, :146, :166, :192,
    :235-240), per agent of ``shapes`` ``(batch, act, obs, critic widths,
    actor widths)``: ks[1] in the parameters' dtype, the spectral starts of
    both networks from ks[2], CAPS from ks[3], and ks[4], ks[5] in the
    default dtype as the DTDE branch draws them.  Under CTDE (``joint``:
    every agent's action width) also the chains from ks[0] and ks[3]
    (sac.py:153-160, :212-220), and ks[4], ks[5] in the parameters' dtype,
    as ``sample_f`` draws them there."""
    out = []
    for batch, act, obs, cws, aws in shapes:
        key, sub = jax.random.split(key)
        ks = jax.random.split(sub, 6)

        def starts(widths):
            return tuple(jax.random.normal(jax.random.fold_in(ks[2], j), (w,),
                                           jdtype)
                         for j, w in enumerate(widths))
        own = jdtype if joint else None
        out.append((jax.random.normal(ks[1], (batch, act), jdtype),
                    jax.random.normal(ks[3], (1, obs), jdtype),
                    jax.random.normal(ks[4], (batch, act), own),
                    jax.random.normal(ks[5], (batch, act), own),
                    starts(cws), starts(aws),
                    split_chain(ks[0], joint, batch, jdtype) if joint
                    else None,
                    split_chain(ks[3], joint, batch, jdtype) if joint
                    else None))
    return out


def _sac_draws(key, agents, batch, dtype, jdtype):
    shapes = tuple((batch, a.action_dim, a.obs_dim, tuple(a.critic_widths),
                    tuple(a.actor_widths)) for a in agents)
    joint = (tuple(a.action_dim for a in agents) if agents[0].is_ctde
             else None)

    def conv(x):
        return None if x is None else tuple(_t(y, dtype) for y in x)
    return tuple(D.SACAgentDraws(_t(nn, dtype), _t(caps, dtype),
                                 _t(npi, dtype), _t(ncaps, dtype),
                                 conv(cs), conv(acs), conv(nj), conv(pj))
                 for nn, caps, npi, ncaps, cs, acs, nj, pj in
                 _sac_draw_arrays(key, shapes, jdtype, joint))


def _learner_to64(st):
    """Parameters and their optimizer states in float64; ``log_alpha`` and
    its optimizer state stay float32, as JAX keeps them."""
    return st.replace(actor=_to64(st.actor), critic=_to64(st.critic),
                      critic_target=_to64(st.critic_target),
                      actor_opt=_to64(st.actor_opt),
                      critic_opt=_to64(st.critic_opt))


@functools.lru_cache(maxsize=None)
def _jax_learner(auto, **kw):
    jcfg, tcfg = _cfgs(automatic_entropy_tuning=auto, **kw)
    agents = [jsac.SACAgent(jcfg, i, jmodels.sac_models(jcfg, i))
              for i in range(jcfg.n_agents)]
    states = [_learner_to64(a.init(jax.random.PRNGKey(20 + i)))
              for i, a in enumerate(agents)]
    step = jax.jit(lambda st, b, k, gate: jsac.train_step(
        jcfg, agents, st, b, k, gate_now=gate), static_argnums=3)
    return jcfg, tcfg, agents, states, step


def _compare_sac(tst, jst, rel, what):
    for name in ("actor", "critic", "critic_target"):
        _close(_np(getattr(tst, name)), ravel_pytree(getattr(jst, name))[0],
               rel, f"{what} {name}")
    for name in ("actor_opt", "critic_opt"):
        t, j = getattr(tst, name), getattr(jst, name)
        _close(_np(t.mu), _adam(j).mu, rel, f"{what} {name}.mu")
        _close(_np(t.nu), _adam(j).nu, rel, f"{what} {name}.nu")
        assert t.count == int(_adam(j).count)
        assert t.sched_count == int(_schedule(j).count)
    assert tst.log_alpha.dtype == torch.float32
    assert jst.log_alpha.dtype == jnp.float32
    _close(_np(tst.log_alpha), jst.log_alpha, max(rel, 1e-6),
           f"{what} log_alpha")
    ja = jst.alpha_opt[0]
    _close(_np(tst.alpha_opt.mu), ja.mu, max(rel, 1e-6), f"{what} alpha mu")
    _close(_np(tst.alpha_opt.nu), ja.nu, max(rel, 1e-6), f"{what} alpha nu")
    assert tst.alpha_opt.count == int(ja.count)
    assert tst.total_it == int(jst.total_it)


@pytest.mark.parametrize("auto", [False, True])
@pytest.mark.parametrize("gate", [False, True])
def test_train_step_matches_jax(gate, auto):
    """One ``train_step`` for both agents from the same state, batch and
    draws, with the critic target's Polyak not taken (``total_it`` 1 -> 2)
    and taken (2 -> 3), with the temperature fixed and auto-tuned: losses,
    ``alpha``, the three networks, ``mu``/``nu`` and the counts, float64
    (``log_alpha`` and its Adam state float32, as in JAX).  The states come
    from JAX after warm-up updates through ``sac_state_from_jax``."""
    train_step_vs_jax(gate, auto)


def train_step_vs_jax(gate, auto, **kw):
    """The check of ``test_train_step_matches_jax`` for ``_cfgs(**kw)``."""
    jcfg, tcfg, jagents, jstates, jstep = _jax_learner(auto, **kw)
    agent_ids = range(jcfg.n_agents)
    rng = np.random.default_rng(30)
    for k in range(2 if gate else 1):
        jb, _ = _batch(rng, jcfg)
        jstates, _ = jstep(jstates, jb, jax.random.PRNGKey(40 + k), False)
    tagents = [tsac.SACAgent(tcfg, i, "cpu", torch.float64)
               for i in agent_ids]
    tstates = [convert.sac_state_from_jax(_np_tree(s), a)
               for s, a in zip(jstates, tagents)]
    for ts, js in zip(tstates, jstates):
        _compare_sac(ts, js, 0.0, "converted")
    jb, tb = _batch(rng, jcfg)
    key = jax.random.PRNGKey(50)
    jnew, jm = jstep(jstates, jb, key, gate)
    draws = _sac_draws(key, tagents, jcfg.batch_size, torch.float64,
                       jnp.float64)
    tstates, tm = tsac.train_step(tcfg, tagents, tstates, tb, draws)
    assert set(tm) == set(jm)
    for i in agent_ids:
        for k in ("critic_loss", "actor_loss", "alpha_loss", "alpha"):
            _close(float(tm[f"agent{i}/{k}"]), float(jm[f"agent{i}/{k}"]),
                   1e-9 if "loss" in k else 1e-6, f"agent {i} {k}")
        assert (float(jm[f"agent{i}/alpha_loss"]) != 0.0) == auto
        _compare_sac(tstates[i], jnew[i], 1e-9, f"agent {i}")
        moved = not np.array_equal(ravel_pytree(jnew[i].critic_target)[0],
                                   ravel_pytree(jstates[i].critic_target)[0])
        assert moved == gate


def test_convert_sac_state_round_trip():
    """``sac_state_from_jax`` lays every network out in ``ravel_pytree``
    order: the port's flat vectors unravel into JAX's trees, its views by
    name are the flax leaves, and the optax states, ``log_alpha`` (float32)
    and ``total_it`` carry."""
    jcfg, tcfg, jagents, jstates, jstep = _jax_learner(True)
    rng = np.random.default_rng(31)
    jb, _ = _batch(rng, jcfg)
    jstates, _ = jstep(jstates, jb, jax.random.PRNGKey(45), False)
    for i, js in enumerate(jstates):
        agent = tsac.SACAgent(tcfg, i, "cpu", torch.float64)
        ts = convert.sac_state_from_jax(_np_tree(js), agent)
        for name, layout in (("actor", agent.actor_layout),
                             ("critic", agent.critic_layout),
                             ("critic_target", agent.critic_layout)):
            jtree = getattr(js, name)
            back = ravel_pytree(jtree)[1](jnp.asarray(_np(getattr(ts, name))))
            jax.tree.map(np.testing.assert_array_equal, back, jtree)
            for n, v in layout.views(getattr(ts, name)).items():
                ref = jtree["params"]
                for part in n.split("."):
                    ref = ref[part]
                np.testing.assert_array_equal(_np(v), np.asarray(ref),
                                              err_msg=n)
        _compare_sac(ts, js, 0.0, f"agent {i}")
        assert ts.total_it == 1 and ts.alpha_opt.count == 1
        assert float(ts.log_alpha) != 0.0
        off = agent.actor_layout.offsets[agent.actor_layout.names.index(
            "network_block0.linear.kernel")]
        assert agent.actor_net.network_block0.linear.kernel.data_ptr() \
            == ts.actor.data_ptr() + 8 * off


# ---------------------------------------------------------------------------
# Supersteps
# ---------------------------------------------------------------------------
def _sac_hooks(agents):
    """``train.py:343-368``'s SAC hooks of the JAX superstep."""
    def act_prep(states):
        return [a.fold_actor(states[i].actor) for i, a in enumerate(agents)]

    def act_fn(folded, ob, noise_std, k):
        acts = []
        for i, a in enumerate(agents):
            k, sub = jax.random.split(k)
            acts.append(a.choose_action_f(folded[i], ob[i], sub))
        return jnp.concatenate(acts, axis=-1)
    return dict(train_fn=jsac.train_step, act_fn=act_fn, act_prep=act_prep)


def _sac_act(agents, states, ob, noise_std, k):
    hooks = _sac_hooks(agents)
    return hooks["act_fn"](hooks["act_prep"](states), ob, noise_std, k)


SAC = OffPolicy(
    jax_agent=lambda jcfg, i: jsac.SACAgent(jcfg, i,
                                            jmodels.sac_models(jcfg, i)),
    jax_hooks=_sac_hooks, jax_act=_sac_act,
    port_agent=lambda tcfg, i: tsac.SACAgent(tcfg, i, "cpu"),
    port_hooks=tsac.superstep_hooks, convert=convert.sac_state_from_jax,
    draws=_sac_draws, compare=_compare_sac,
    losses=("critic_loss", "actor_loss", "alpha"), rel=1e-4)


def test_sac_superstep_matches_jax():
    """2 warm + 3 train supersteps (one tick, one update each) against
    ``make_sharded_td3_superstep(train_fn=sac.train_step, act_fn=...,
    act_prep=...)`` on a 1-device CPU mesh as ``train.py:343-368`` builds
    it, float32, from the same envs, ring and learner states and with JAX's
    draws: the env tick's, the acting samples', the sample indices and the
    update draws, each rebuilt from the superstep's key
    (``test_torch_td3.py::superstep_vs_jax``)."""
    superstep_vs_jax(SAC, rl_algo="SAC")


def test_sac_train_loop_cpu():
    """``train(Config(rl_algo="SAC"))`` on the CPU at a tiny size: finite
    losses, every network moves (the critic target only on gate updates),
    no exploration-noise decay, ``alpha`` moves only with auto-tuning on,
    and no kernel launch."""
    from gym_rotor_tpu_torch.train import train
    wrappers = [kactor.sac_actor, K10.sac_head, K10.sac_head_backward]
    before = [w.launches for w in wrappers]
    for auto in (False, True):
        tcfg = TConfig(num_envs=6, max_steps=4, start_timesteps=12,
                       batch_size=8, replay_buffer_size=40, critic_hidden_dim=8,
                       actor_hidden_dim=(8, 4), max_timesteps=600,
                       rl_algo="SAC", automatic_entropy_tuning=auto)
        seen, snaps = [], []

        def probe(i, warm, m, run):
            seen.append((warm, {k: float(v) for k, v in m.items()
                                if k.startswith("agent")}))
            snaps.append([(s.actor.clone(), s.critic.clone(),
                           s.critic_target.clone(), float(s.log_alpha))
                          for s in run["states"]])
        run = train(tcfg, 6, device="cpu", log=None, on_superstep=probe)
        assert [w for w, _ in seen] == [True, True, False, False, False, False]
        assert run["noise_std"] == tcfg.explor_noise_std_init
        assert [s.total_it for s in run["states"]] == [4, 4]
        for _, m in seen[2:]:
            assert all(np.isfinite(v) for v in m.values())
            assert (m["agent0/alpha"] != np.float32(tcfg.sac_alpha)) == auto
        for k in range(2, 6):
            gate = (k - 1) % tcfg.policy_update_freq == 0
            for (a0, c0, t0, l0), (a1, c1, t1, l1) in zip(snaps[k - 1],
                                                           snaps[k]):
                assert not torch.equal(a0, a1) and not torch.equal(c0, c1)
                assert torch.equal(t0, t1) != gate
                assert (l0 != l1) == auto
    assert [w.launches for w in wrappers] == before


def test_sac_update_draws_shapes():
    """``make_sac_update_draws``: per agent the target sample's noise, the
    CAPS draw, ``n_pi`` and ``n_caps``, and one start vector per
    regularized weight of each network."""
    _, tcfg = _cfgs()
    agents = [tsac.SACAgent(tcfg, i, "cpu") for i in AGENTS]
    ud = D.make_sac_update_draws(
        16, 5, tcfg.obs_dim_n, tcfg.action_dim_n,
        [a.critic_widths for a in agents], [a.actor_widths for a in agents],
        torch.Generator().manual_seed(0), "cpu")
    assert ud.idx.shape == (16,) and int(ud.idx.max()) < 5
    for a, d in zip(agents, ud.agents):
        assert d.next_noise.shape == d.n_pi.shape == d.n_caps.shape == (
            16, a.action_dim)
        assert d.caps_eps.shape == (1, a.obs_dim)
        assert [s.shape[0] for s in d.critic_starts] == a.critic_widths
        assert [s.shape[0] for s in d.actor_starts] == a.actor_widths


def test_sac_constants_match_jax():
    assert (tmlp.LOG_SIG_MAX, tmlp.LOG_SIG_MIN, tmlp.EPS) == (
        jmlp.LOG_SIG_MAX, jmlp.LOG_SIG_MIN, jmlp.EPS)
    _, tcfg = _cfgs()
    assert tsac.SACAgent(tcfg, 0, "cpu").target_entropy == -4.0
