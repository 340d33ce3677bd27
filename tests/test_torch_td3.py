"""PyTorch port vs the JAX package: the TD3 learner (DTDE) and the
single-device superstep, on the plain twins of K3/K4 (EMLP blocks), K6 (flat
AdamW), K7 (power iteration) and K2/K8 (ring, episode stats).  The CUDA
kernels are held to the same twins by chip_smoke.py on the card.

Narrow widths that keep every bilinear regime: critics of 8 hidden
channels (agent 0's SO2eR3 tower has ``pairs``; agent 1's Mirror tower
``col_groups``, ``row_groups`` and ``s1``) and actors of 8 / 4.  Random
draws are JAX's own, rebuilt from its key chain.

Tolerances.  Float64: within 1e-9 of the compared vector's largest entry
(the port projects each layer once per loss and fans it out where JAX
projects on every forward, and sums in another order).  Float32 (the
superstep, as JAX runs it): the env state within the tick's own float32
bounds (``test_torch_env.py``); losses and parameters within 1e-4 and
1e-5 relative, because JAX under x64 draws the target-smoothing noise in
float64 (``td3.py:228`` names no dtype) and so computes the target Q in
float64 where the port stays in float32.
"""
import functools
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from jax.flatten_util import ravel_pytree

from gym_rotor_tpu.algos import common as jcommon
from gym_rotor_tpu.algos import regularizers as jreg
from gym_rotor_tpu.algos import td3 as jtd3
from gym_rotor_tpu.algos.replay import Batch as JBatch
from gym_rotor_tpu.envs import batch as jbatch
from gym_rotor_tpu.models import zoo as jmodels
from gym_rotor_tpu.models.emlp import nn as jnn
from gym_rotor_tpu.models.emlp import zoo as jzoo
from gym_rotor_tpu.parallel import mesh as jmesh
from gym_rotor_tpu.parallel.train_step import (init_ep_ret,
                                               make_sharded_td3_superstep,
                                               sharded_init)
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch import convert
from gym_rotor_tpu_torch.algos import common as tcommon
from gym_rotor_tpu_torch.algos import regularizers as treg
from gym_rotor_tpu_torch.algos import td3 as ttd3
from gym_rotor_tpu_torch.algos.replay import Batch as TBatch
from gym_rotor_tpu_torch.envs import draws as D
from gym_rotor_tpu_torch.kernels import emlp_block as kblock
from gym_rotor_tpu_torch.kernels.env_tick import TickLoop
from gym_rotor_tpu_torch.models.emlp import nn as tnn
from gym_rotor_tpu_torch.models.emlp import zoo as tzoo
from gym_rotor_tpu_torch.parallel.train_step import make_td3_superstep
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from test_torch_env import _tick_draws
from torch_jax_fixtures import jit_bases_as_args

torch.set_num_threads(1)
NARROW = dict(critic_hidden_dim=8, actor_hidden_dim=(8, 4), batch_size=16)
AGENTS = [0, 1]


def _cfgs(**kw):
    """The JAX and port configs: ``NARROW``, ``kw`` taking precedence."""
    kw = {**NARROW, **kw}
    return JConfig(**kw), TConfig(**kw)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, ref, rel, what=""):
    """|got - ref| <= rel * max(max |ref|, 1e-30), elementwise."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref), initial=0.0)), 1e-30)
    err = float(np.max(np.abs(got - ref), initial=0.0))
    assert err <= rel * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def _to64(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float64)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _np_tree(x):
    return jax.tree.map(np.asarray, serialization.to_state_dict(x))


# ---------------------------------------------------------------------------
# JAX draws in the port's layout
# ---------------------------------------------------------------------------
def split_chain(key, dims, batch, jdtype=None):
    """One N(0, 1) (batch, d) per ``d`` in ``dims`` from a ``split`` chain
    on ``key`` (``kk, kn = split(kk)`` per agent: td3.py:209-221,
    sac.py:153-160, :212-220); ``jdtype`` None is JAX's default dtype."""
    out = []
    for d in dims:
        key, kn = jax.random.split(key)
        out.append(jax.random.normal(kn, (batch, d), jdtype))
    return tuple(out)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _update_draw_arrays(key, shapes, jdtype, joint):
    """``train_step``'s draws from its key (td3.py:187-189, :200, :228;
    regularizers.py:55, :129), one jitted program: per agent of
    ``shapes`` ``(batch, act, obs, critic widths, actor widths)``, the
    target noise (default dtype, as td3.py:228 draws it; under CTDE, when
    ``joint`` holds every agent's action width, one per agent from the
    ``k_noise`` chain), the CAPS draw and the spectral start vectors."""
    out = []
    for batch, act, obs, cws, aws in shapes:
        key, sub = jax.random.split(key)
        k_noise, k_caps, k_spec, k_spec2 = jax.random.split(sub, 4)

        def starts(k, widths):
            return tuple(jax.random.normal(jax.random.fold_in(k, j), (w,),
                                           jdtype)
                         for j, w in enumerate(widths))
        target = (split_chain(k_noise, joint, batch) if joint else
                  jax.random.normal(k_noise, (batch, act)))
        out.append((target, jax.random.normal(k_caps, (1, obs), jdtype),
                    starts(k_spec, cws), starts(k_spec2, aws)))
    return out


def _update_draws(key, agents, batch, dtype, jdtype):
    """JAX's update draws as the port's ``AgentDraws``, one per agent
    (CTDE: every agent's target noise per agent)."""
    shapes = tuple((batch, a.action_dim, a.obs_dim, tuple(a.critic_widths),
                    tuple(a.actor_widths)) for a in agents)
    joint = (tuple(a.action_dim for a in agents) if agents[0].is_ctde
             else None)

    def conv(x):
        return tuple(_t(y, dtype) for y in x) if isinstance(x, tuple) \
            else _t(x, dtype)
    return tuple(D.AgentDraws(conv(tn), _t(caps, dtype),
                              tuple(_t(x, dtype) for x in cs),
                              tuple(_t(x, dtype) for x in acs))
                 for tn, caps, cs, acs in _update_draw_arrays(
                     key, shapes, jdtype, joint))


def _policy_arrays(sub, batch, act_dims, warm):
    """One tick's policy draws from its key ``sub``: the warm uniforms
    (train_step.py:120) or each agent's N(0, 1) from a split chain (the
    TD3 policy's, ``:124-128``, and SAC's ``act_fn``, ``train.py:358-363``,
    alike)."""
    if warm:
        return jax.random.uniform(sub, (batch, sum(act_dims)), jnp.float32)
    return split_chain(sub, act_dims, batch, jnp.float32)


def _adam(opt):
    return opt[1][0]            # chain(clip, adamw(scale_by_adam, ...))


def _schedule(opt):
    return opt[1][2]


def _compare_td3(tst, jst, rel, what):
    for name in ("actor", "critic", "actor_target", "critic_target"):
        _close(_np(getattr(tst, name)), ravel_pytree(getattr(jst, name))[0],
               rel, f"{what} {name}")
    for name in ("actor_opt", "critic_opt"):
        t, j = getattr(tst, name), getattr(jst, name)
        _close(_np(t.mu), _adam(j).mu, rel, f"{what} {name}.mu")
        _close(_np(t.nu), _adam(j).nu, rel, f"{what} {name}.nu")
        assert t.count == int(_adam(j).count)
        assert t.sched_count == int(_schedule(j).count)
    assert tst.total_it == int(jst.total_it)


# ---------------------------------------------------------------------------
# Networks
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _flax_critic(agent_id):
    """The flax twin critic of agent ``agent_id`` and seeded params."""
    jcfg, _ = _cfgs()
    mod = jzoo.EMLPCriticTwin(*jzoo.critic_reps(jcfg, "MODUL", agent_id, "DTDE"))
    params = mod.init(jax.random.PRNGKey(5 + agent_id),
                      jnp.zeros((1, jcfg.obs_dim_n[agent_id])),
                      jnp.zeros((1, jcfg.action_dim_n[agent_id])))
    return mod, params


@pytest.mark.parametrize("agent_id", AGENTS)
def test_critic_reps_and_layout_match_jax(agent_id):
    """Reps, gated widths and the flat layout equal the flax critic's
    ``ravel_pytree`` order and sizes."""
    jcfg, tcfg = _cfgs()
    jreps = jzoo.critic_reps(jcfg, "MODUL", agent_id, "DTDE")
    treps = tzoo.critic_reps(tcfg, "MODUL", agent_id, "DTDE")
    assert [r.size for r in treps] == [r.size for r in jreps]
    agent = ttd3.TD3Agent(tcfg, agent_id, "cpu")
    _, params = _flax_critic(agent_id)
    assert ravel_pytree(params)[0].size == agent.critic_layout.size
    ws, extras = jnn.spectral_weights(params)
    assert [int(w.shape[1]) for w in ws] == agent.critic_widths
    flat = convert.flat_from_jax(_np_tree(params), agent.critic_layout, "cpu")
    tws, textras = tnn.spectral_weights(agent.critic_layout.views(flat))
    for a, b in zip(tws + textras, ws + extras):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    net1, net2 = tzoo.emlp_twin_split(agent.critic_layout.views(flat))
    j1, j2 = jzoo.emlp_twin_split(params)
    for tp, jp in ((net1, j1), (net2, j2)):
        np.testing.assert_array_equal(
            _np(torch.cat([tp[n].reshape(-1) for n in sorted(
                tp, key=lambda n: tuple(n.split(".")))])),
            np.asarray(ravel_pytree(jp)[0]))


@pytest.mark.parametrize("agent_id", AGENTS)
def test_emlp_block_matches_flax(agent_id):
    """One critic ``EMLPBlock`` through the block function (K3/K4's plain
    twins under autograd) vs flax: forward and ``jax.grad`` with respect to
    x, kernel, bias and bi_params, float64."""
    jcfg, tcfg = _cfgs()
    jin, jhid, _ = jzoo.critic_reps(jcfg, "MODUL", agent_id, "DTDE")
    tin, thid, _ = tzoo.critic_reps(tcfg, "MODUL", agent_id, "DTDE")
    rng = np.random.default_rng(agent_id)
    x = rng.normal(0, 0.7, (24, jin.size))
    wout = rng.normal(size=(24, jhid.size))
    blk = jnn.EMLPBlock(jin, jhid)
    params = _to64(blk.init(jax.random.PRNGKey(3), jnp.zeros((1, jin.size))))

    def f(p, xx):
        return jnp.sum(blk.apply(p, xx) * wout)
    val, (gp, gx) = jax.value_and_grad(f, argnums=(0, 1))(params, jnp.asarray(x))

    tblk = tnn.EMLPBlock(tin, thid, device="cpu", dtype=torch.float64)
    p = params["params"]
    leaves = {n: _t(a).requires_grad_(True) for n, a in (
        ("kernel", p["linear"]["kernel"]), ("bias", p["linear"]["bias"]),
        ("bi_params", p["bilinear"]["bi_params"]))}
    xt = _t(x).requires_grad_(True)
    W, b = tnn.project_linear(tin, tnn.gated(thid), leaves["kernel"],
                              leaves["bias"])
    v = tnn.bilinear_sparse(tblk.bilinear.rep, leaves["bi_params"])[3]
    h = kblock.block_apply(kblock.block_spec(tblk, "cpu"), xt, W, b, v)
    tval = (h * _t(wout)).sum()
    tval.backward()
    _close(float(tval.detach()), float(val), 1e-9, "value")
    _close(_np(xt.grad), gx, 1e-9, "grad x")
    for name, ref in (("kernel", gp["params"]["linear"]["kernel"]),
                      ("bias", gp["params"]["linear"]["bias"]),
                      ("bi_params", gp["params"]["bilinear"]["bi_params"])):
        _close(_np(leaves[name].grad), ref, 1e-9, f"grad {name}")


@pytest.mark.parametrize("agent_id", AGENTS)
def test_twin_critic_matches_flax(agent_id):
    """The twin critic on the training path (``TD3Agent.critic_apply``:
    projection once, then the block function per block) vs flax's
    ``EMLPCriticTwin``: both Qs and the gradient with respect to the flat
    parameters (``ravel_pytree`` order), obs and actions, float64; and the
    port's structured critic loaded with ``critic_params_from_jax``."""
    jcfg, tcfg = _cfgs()
    agent = ttd3.TD3Agent(tcfg, agent_id, "cpu", torch.float64)
    mod, params = _flax_critic(agent_id)
    params = _to64(params)
    rng = np.random.default_rng(10 + agent_id)
    obs = rng.normal(0, 0.5, (16, agent.obs_dim))
    act = rng.uniform(-1, 1, (16, agent.action_dim))
    w1, w2 = rng.normal(size=(2, 16, 1))

    def f(p, o, a):
        q1, q2 = mod.apply(p, o, a)
        return jnp.sum(q1 * w1) + jnp.sum(q2 * w2), (q1, q2)
    (val, (q1, q2)), (gp, go, ga) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(obs),
                                           jnp.asarray(act))
    flat = convert.flat_from_jax(_np_tree(params), agent.critic_layout, "cpu",
                                 torch.float64).requires_grad_(True)
    ot, at = _t(obs).requires_grad_(True), _t(act).requires_grad_(True)
    tq1, tq2 = agent.critic_apply(agent.critic_layout.views(flat), ot, at)
    ((tq1 * _t(w1)).sum() + (tq2 * _t(w2)).sum()).backward()
    _close(_np(tq1), q1, 1e-9, "q1")
    _close(_np(tq2), q2, 1e-9, "q2")
    _close(_np(flat.grad), ravel_pytree(gp)[0], 1e-9, "grad params")
    _close(_np(ot.grad), go, 1e-9, "grad obs")
    _close(_np(at.grad), ga, 1e-9, "grad act")
    critic = tzoo.EMLPCriticTwin(*tzoo.critic_reps(tcfg, "MODUL", agent_id,
                                                    "DTDE"),
                                 device="cpu", dtype=torch.float64)
    critic.load_state_dict(convert.critic_params_from_jax(_np_tree(params),
                                                          tcfg, agent_id))
    with torch.no_grad():
        sq1 = critic.q1(_t(obs), _t(act))
    _close(_np(sq1), q1, 1e-12, "structured q1")


# ---------------------------------------------------------------------------
# Optimizer and regularizers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("clip,scale", [(True, 1.0), (True, 1e4), (False, 1e4)])
def test_flat_optimizer_matches_optax(clip, scale):
    """Three steps of the flat chain (K6's plain twin) vs optax
    (``make_optimizer`` + ``flat_init``), float64: the gradient's norm is
    ~20 or ~2e5 against the clip of 100, with the clip on and off."""
    jcfg, tcfg = _cfgs(use_clip_grad_norm=clip)
    rng = np.random.default_rng(int(scale) + clip)
    n = 400
    p0 = rng.normal(size=n)
    jtx = jcommon.make_optimizer(jcfg, 3e-4)
    jp = jnp.asarray(p0)
    jopt = jtx.init(jp)
    ttx = tcommon.make_optimizer(tcfg, 3e-4)
    tp = _t(p0)
    tgt0 = rng.normal(size=n)
    tgt, jtgt = _t(tgt0), jnp.asarray(tgt0)
    topt = ttx.init(tp)
    for k in range(3):
        g = rng.normal(size=n) * scale
        upd, jopt = jtx.update(jnp.asarray(g), jopt, jp)
        jp = jp + upd
        topt = ttx.update(tp, _t(g), topt, target=tgt if k == 2 else None,
                          tau=tcfg.tau)
        _close(_np(tp), jp, 1e-9, f"step {k} params")
        _close(_np(topt.mu), _adam(jopt).mu, 1e-9, f"step {k} mu")
        _close(_np(topt.nu), _adam(jopt).nu, 1e-9, f"step {k} nu")
        assert topt.count == int(_adam(jopt).count) == k + 1
        assert topt.sched_count == int(_schedule(jopt).count) == k + 1
    ref = jcommon.flat_polyak(jtgt, jp, tcfg.tau, ravel_pytree(jtgt)[1])
    _close(_np(tgt), ref, 1e-12, "polyak in the step")
    _close(_np(tcommon.flat_polyak(_t(tgt0), tp, tcfg.tau)), ref, 1e-12,
           "flat_polyak")


def test_cosine_schedule_matches_jax():
    sched_j = jcommon.cosine_warm_restarts(3e-4)
    sched_t = tcommon.cosine_warm_restarts(3e-4)
    for c in (0, 1, 7, 500_000, 999_999, 1_000_000, 1_234_567):
        assert sched_t(c) == float(sched_j(jnp.asarray(c, jnp.int32))), c


def test_spectral_norm_regularization_matches_jax():
    """Value and gradient (with respect to every weight and extra), the
    start vectors drawn as JAX draws them (``fold_in(key, i)``), float64."""
    rng = np.random.default_rng(7)
    shapes = [(9, 5), (9, 8), (1, 8), (7, 3)]
    ws = [rng.normal(size=s) for s in shapes]
    extras = [rng.normal(size=12), rng.normal(size=4)]
    key = jax.random.PRNGKey(11)

    def f(w, e):
        return jreg.spectral_norm_regularization(w, key, e)
    val, (gw, ge) = jax.value_and_grad(f, argnums=(0, 1))(
        [jnp.asarray(w) for w in ws], [jnp.asarray(e) for e in extras])
    starts = [_t(jax.random.normal(jax.random.fold_in(key, i), (s[1],),
                                   jnp.float64)) for i, s in enumerate(shapes)]
    tw = [_t(w).requires_grad_(True) for w in ws]
    te = [_t(e).requires_grad_(True) for e in extras]
    tval = treg.spectral_norm_regularization(tw, starts, te)
    tval.backward()
    _close(float(tval.detach()), float(val), 1e-9, "value")
    for a, b in zip(tw + te, list(gw) + list(ge)):
        _close(_np(a.grad), b, 1e-9, "grad")
    one = treg.approx_spectral_norm(_t(ws[0]), starts[0])
    _close(float(one), float(jreg.approx_spectral_norm(
        jnp.asarray(ws[0]), jax.random.fold_in(key, 0))), 1e-9, "one")


def test_caps_terms_match_jax():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(8)
    acts = [rng.uniform(-1, 1, (16, 4)) for _ in range(3)]
    for agent_id in AGENTS:
        ref = jreg.caps_terms(jcfg, agent_id, *map(jnp.asarray, acts))
        got = treg.caps_terms(tcfg, agent_id, *map(_t, acts))
        _close(float(got), float(ref), 1e-12, f"agent {agent_id}")
    assert treg.hover_action_scalar() == jreg.hover_action_scalar()


# ---------------------------------------------------------------------------
# One update
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_learner(bases_as_args=False, **kw):
    """JAX agents of ``_cfgs(**kw)`` (EMLP or MLP networks), float64 states
    and the jitted ``train_step`` with the gate placed statically (with
    ``bases_as_args``, the large EMLP bases passed to XLA as arguments:
    ``torch_jax_fixtures.jit_bases_as_args``)."""
    jcfg, tcfg = _cfgs(**kw)
    agents = [jtd3.TD3Agent(jcfg, i, jmodels.td3_models(jcfg, i))
              for i in range(jcfg.n_agents)]
    states = [_to64(a.init(jax.random.PRNGKey(20 + i)))
              for i, a in enumerate(agents)]
    # the gate placed statically (bit-identical to the runtime cond,
    # tests/test_algos.py): under float64 the cond's skipped branch returns
    # a float32 zero loss and would not type-check
    step = (jit_bases_as_args if bases_as_args else jax.jit)(
        lambda st, b, k, gate: jtd3.train_step(
            jcfg, agents, st, b, k, gate_now=gate), static_argnums=(3,))
    return jcfg, tcfg, agents, states, step


def _batch(rng, cfg):
    B = cfg.batch_size
    obs = tuple(rng.normal(0, 0.5, (B, d)) for d in cfg.obs_dim_n)
    act = tuple(rng.uniform(-1, 1, (B, d)) for d in cfg.action_dim_n)
    rwd = tuple(rng.uniform(0, 1, (B, 1)) for _ in cfg.obs_dim_n)
    nxt = tuple(rng.normal(0, 0.5, (B, d)) for d in cfg.obs_dim_n)
    done = tuple((rng.uniform(size=(B, 1)) < 0.2).astype(np.float64)
                 for _ in cfg.obs_dim_n)
    fields = (obs, act, rwd, nxt, done)
    return (JBatch(*(tuple(map(jnp.asarray, f)) for f in fields)),
            TBatch(*(tuple(map(_t, f)) for f in fields)))


@pytest.mark.parametrize("gate", [False, True])
def test_train_step_matches_jax(gate):
    """One ``train_step`` for both agents from the same state, batch and
    draws, with the delayed actor step not taken (``total_it`` 1 -> 2) and
    taken (2 -> 3): losses, parameters, both targets, ``mu``/``nu`` and the
    counts, float64.  The states come from JAX after warm-up updates (so
    the Adam counts and moments are nonzero) through ``td3_state_from_jax``."""
    train_step_vs_jax(gate)


def train_step_vs_jax(gate, **kw):
    """The check of ``test_train_step_matches_jax`` for ``_cfgs(**kw)``."""
    jcfg, tcfg, jagents, jstates, jstep = _jax_learner(**kw)
    agent_ids = range(jcfg.n_agents)
    rng = np.random.default_rng(30)
    for k in range(2 if gate else 1):
        jb, _ = _batch(rng, jcfg)
        jstates, _ = jstep(jstates, jb, jax.random.PRNGKey(40 + k), False)
    tagents = [ttd3.TD3Agent(tcfg, i, "cpu", torch.float64)
               for i in agent_ids]
    tstates = [convert.td3_state_from_jax(_np_tree(s), a)
               for s, a in zip(jstates, tagents)]
    for ts, js, a in zip(tstates, jstates, tagents):
        _compare_td3(ts, js, 0.0, "converted")
    jb, tb = _batch(rng, jcfg)
    key = jax.random.PRNGKey(50)
    jnew, jm = jstep(jstates, jb, key, gate)
    draws = _update_draws(key, tagents, jcfg.batch_size, torch.float64,
                          jnp.float64)
    tstates, tm = ttd3.train_step(tcfg, tagents, tstates, tb, draws)
    for i in agent_ids:
        _close(float(tm[f"agent{i}/critic_loss"]),
               float(jm[f"agent{i}/critic_loss"]), 1e-9, "critic loss")
        _close(float(tm[f"agent{i}/actor_loss"]),
               float(jm[f"agent{i}/actor_loss"]), 1e-9, "actor loss")
        assert (float(jm[f"agent{i}/actor_loss"]) != 0.0) == gate
        _compare_td3(tstates[i], jnew[i], 1e-9, f"agent {i}")


def test_convert_td3_state_round_trip():
    """``td3_state_from_jax`` lays every network out in ``ravel_pytree``
    order (so the flat optax ``mu``/``nu`` of ``flat_init`` carry across as
    they are): the port's flat vectors unravel into JAX's trees, its views
    by name are the flax leaves, and the counts and ``total_it`` carry."""
    jcfg, tcfg, jagents, jstates, jstep = _jax_learner()
    rng = np.random.default_rng(31)
    jb, _ = _batch(rng, jcfg)
    jstates, _ = jstep(jstates, jb, jax.random.PRNGKey(45), False)
    for i, (js, ja) in enumerate(zip(jstates, jagents)):
        agent = ttd3.TD3Agent(tcfg, i, "cpu", torch.float64)
        ts = convert.td3_state_from_jax(_np_tree(js), agent)
        for name, layout in (("actor", agent.actor_layout),
                             ("critic", agent.critic_layout),
                             ("actor_target", agent.actor_layout),
                             ("critic_target", agent.critic_layout)):
            jtree = getattr(js, name)
            unravel = ravel_pytree(jtree)[1]
            back = unravel(jnp.asarray(_np(getattr(ts, name))))
            jax.tree.map(np.testing.assert_array_equal, back, jtree)
            leaves = jtree["params"]
            for n, v in layout.views(getattr(ts, name)).items():
                ref = leaves
                for part in n.split("."):
                    ref = ref[part]
                np.testing.assert_array_equal(_np(v), np.asarray(ref), err_msg=n)
        fresh = jcommon.flat_init(ja.actor_tx, js.actor)
        assert _adam(fresh).mu.shape == tuple(ts.actor_opt.mu.shape)
        _compare_td3(ts, js, 0.0, f"agent {i}")
        assert ts.total_it == 1 and ts.critic_opt.count == 1


# ---------------------------------------------------------------------------
# Supersteps
# ---------------------------------------------------------------------------
def test_superstep_matches_jax():
    """2 warm + 3 train supersteps (one tick, one update each) against
    ``make_sharded_td3_superstep`` on a 1-device CPU mesh, float32 as JAX
    runs it, from the same envs, ring and learner states and with JAX's
    draws: the env tick's and actors' uniform/normal draws, the sample
    indices and the update draws, each rebuilt from the superstep's key."""
    superstep_vs_jax()


class OffPolicy(NamedTuple):
    """An off-policy learner as ``superstep_vs_jax`` drives it, in JAX and
    in the port."""
    jax_agent: Callable      # (jcfg, i) -> JAX agent
    jax_hooks: Callable      # JAX agents -> make_sharded_td3_superstep kwargs
    jax_act: Callable        # (agents, states, obs, noise_std, key) -> action
    port_agent: Callable     # (tcfg, i) -> the port's agent on the CPU
    port_hooks: Callable     # port agents -> make_td3_superstep kwargs
    convert: Callable        # (JAX state tree, port agent) -> port state
    draws: Callable          # _update_draws' signature
    compare: Callable        # (port state, JAX state, rel, what)
    losses: Tuple[str, ...]  # the loss metrics compared (rel 1e-4)
    rel: float               # the learner states' bound after a superstep


def _td3_act(agents, states, ob, noise_std, k):
    """The superstep's default TD3 policy (train_step.py:122-129)."""
    acts = []
    for i, a in enumerate(agents):
        k, sub = jax.random.split(k)
        acts.append(a.choose_action_f(a.fold_actor(states[i].actor), ob[i],
                                      noise_std, sub))
    return jnp.concatenate(acts, axis=-1)


TD3 = OffPolicy(
    jax_agent=lambda jcfg, i: jtd3.TD3Agent(jcfg, i,
                                            jmodels.td3_models(jcfg, i)),
    jax_hooks=lambda agents: {}, jax_act=_td3_act,
    port_agent=lambda tcfg, i: ttd3.TD3Agent(tcfg, i, "cpu"),
    port_hooks=lambda agents: {}, convert=convert.td3_state_from_jax,
    draws=_update_draws, compare=_compare_td3,
    losses=("critic_loss", "actor_loss"), rel=1e-5)


def superstep_vs_jax(algo: OffPolicy = TD3, supersteps=(2, 3),
                     rollout_len=1, n_updates=1, **cfg_kw):
    """The check of ``test_superstep_matches_jax`` for ``_cfgs(**cfg_kw)``
    (MODUL or MONO, DTDE or CTDE, EMLP or MLP networks) and ``algo`` (TD3
    or SAC, ``test_torch_sac.py``): ``supersteps`` warm then train
    supersteps of ``rollout_len`` ticks and ``n_updates`` updates each.
    Each tick's env draws and acting draws come from JAX's keys, the
    rollout replayed on the JAX side from the superstep's starting state to
    reach each tick's env keys; each update's sample indices and draws from
    its key (train_step.py:157-164).  The learner states are held to
    ``algo.rel``."""
    kw = dict(num_envs=8, replay_buffer_size=28, max_steps=3, **cfg_kw)
    jcfg, tcfg = _cfgs(**kw)
    agent_ids = range(jcfg.n_agents)
    mesh = jmesh.make_mesh(1)
    jagents = [algo.jax_agent(jcfg, i) for i in agent_ids]
    jstates = [jax.device_put(a.init(jax.random.PRNGKey(60 + i)),
                              jmesh.replicated(mesh))
               for i, a in enumerate(jagents)]
    jbs, jobs, jrs = sharded_init(jcfg, mesh, jax.random.PRNGKey(61))
    jep = init_ep_ret(jcfg, mesh)
    jstep = make_sharded_td3_superstep(jcfg, jagents, mesh,
                                       rollout_len=rollout_len,
                                       n_updates=n_updates,
                                       **algo.jax_hooks(jagents))

    tagents = [algo.port_agent(tcfg, i) for i in agent_ids]
    tstates = [algo.convert(_np_tree(s), a) for s, a in zip(jstates, tagents)]
    loop = TickLoop(tcfg, convert.env_state_from_numpy(_np_tree(jbs),
                                                       device="cpu"))
    tobs = tuple(_t(o) for o in jobs)
    trs = convert.replay_state_from_jax(_np_tree(jrs), tcfg.obs_dim_n,
                                        tcfg.action_dim_n, device="cpu")
    tep = torch.zeros(tcfg.num_envs, tcfg.n_agents)
    tstep = make_td3_superstep(tcfg, tagents, "cpu", rollout_len=rollout_len,
                               n_updates=n_updates, **algo.port_hooks(tagents))
    B, noise_std = jcfg.num_envs, 0.3
    act_dims = tuple(jcfg.action_dim_n)
    draws_fn = jax.jit(lambda b: _tick_draws(b, jnp.float32))

    @functools.partial(jax.jit, static_argnums=4)
    def replay_tick(bs, ob, states, sub, warm):
        """One tick of the superstep's scan (train_step.py:132-143)."""
        if warm:
            actions = jax.random.uniform(sub, (B, sum(act_dims)),
                                         jnp.float32, -1.0, 1.0)
        else:
            actions = algo.jax_act(jagents, states, ob,
                                   jnp.float32(noise_std), sub)
        bs, out = jbatch.batched_step(jcfg, bs, actions)
        return bs, out.obs

    resets = 0
    for s in range(sum(supersteps)):
        warm = s < supersteps[0]
        key = jax.random.PRNGKey(70 + s)
        k_roll, k_upd = jax.random.split(jax.random.fold_in(key, 0))
        ticks, bs, ob, k = [], jbs, jobs, k_roll
        for _ in range(rollout_len):
            k, sub = jax.random.split(k)
            policy = _policy_arrays(sub, B, act_dims, warm)
            ticks.append(D.TickDraws(_t(draws_fn(bs)), _t(policy) if warm
                                     else tuple(map(_t, policy))))
            bs, ob = replay_tick(bs, ob, jstates, sub, warm)
        jbs, jobs, jrs, jstates, jep, jm = jstep(jbs, jobs, jrs, jstates, jep,
                                                  key, noise_std, warm=warm)
        updates = []
        if not warm:
            for ku in jax.random.split(k_upd, n_updates):
                k_s, k_u = jax.random.split(ku)
                idx = jax.random.randint(k_s, (jcfg.batch_size,), 0,
                                         jnp.maximum(jrs.filled, 1))
                updates.append(D.UpdateDraws(_t(idx).long(), algo.draws(
                    k_u, tagents, jcfg.batch_size, torch.float32,
                    jnp.float32)))
        tobs, tm = tstep(loop, tobs, trs, tstates, tep, noise_std, warm=warm,
                         draws=(ticks, updates))
        what = f"superstep {s}"
        for a, b in zip(tobs, jobs):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2e-5,
                                       atol=2e-6, err_msg=what)
        np.testing.assert_allclose(_np(trs.data), np.asarray(jrs.data),
                                   rtol=2e-5, atol=2e-6, err_msg=what)
        assert (trs.ptr, trs.filled) == (int(jrs.ptr), int(jrs.filled))
        np.testing.assert_allclose(_np(tep), np.asarray(jep), rtol=1e-5,
                                   atol=1e-5, err_msg=what)
        np.testing.assert_allclose(float(tm["mean_reward"]),
                                   float(jm["mean_reward"]), rtol=1e-5)
        np.testing.assert_allclose(_np(tm["fin_sum"]), np.asarray(jm["fin_sum"]),
                                   rtol=1e-5, atol=1e-5)
        assert float(tm["fin_cnt"]) == float(jm["fin_cnt"])
        resets += int(jm["fin_cnt"])
        if warm:
            assert set(tm) == set(jm) == {"mean_reward", "fin_sum", "fin_cnt"}
            continue
        assert set(tm) == set(jm)
        for i in agent_ids:
            for k in algo.losses:
                np.testing.assert_allclose(float(tm[f"agent{i}/{k}"]),
                                           float(jm[f"agent{i}/{k}"]),
                                           rtol=1e-4, atol=1e-7,
                                           err_msg=f"{what} agent {i} {k}")
            algo.compare(tstates[i], jstates[i], algo.rel,
                         f"{what} agent {i}")
    assert resets > 0 and trs.filled == jcfg.replay_buffer_size
    return tstates
