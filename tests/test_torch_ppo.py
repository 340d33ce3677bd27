"""PyTorch port vs the JAX package: the PPO learner (DTDE), on the plain
twins of K12 (GAE), K13 (the clipped surrogate, forward and backward), K11
(the fused PPO actor's acting draw), K3/K4, K6, K7 and K2/K8.  The CUDA
kernels are held to the same twins by chip_smoke.py on the card.

Narrow widths that keep every bilinear regime, as ``test_torch_td3.py``:
V critics of 8 hidden channels, actors of 8 / 4, 4 envs, a horizon of 16
rows (4 ticks), minibatches of 4, 2 epochs.  Random draws are JAX's own,
rebuilt from its key chain (``envs/draws.py::PPOEpochDraws``).

Tolerances.
- GAE, float64: within 1e-12 of the compared array's largest entry (the
  same recursion; the mean and variance summed in another order).
- Networks, float64: the structured forwards within 1e-12, the training
  path's (projection once per loss, the block function per block) within
  1e-9; acting within 1e-12.
- K13 against ``jax.value_and_grad`` of ``ppo.py:250-258``'s expression,
  float64: within 1e-12 of the compared array's largest entry, on rows
  inside the clip range, outside it on both sides with both signs of the
  advantage, with a zero advantage, and exactly at ``1 +- clip_rate``.
- One ``train_step``, float64: within 1e-9 of the compared vector's
  largest entry, as for TD3 and SAC.
- Two supersteps, float32 as JAX runs them: the env state within the
  tick's float32 bounds (``test_torch_env.py``); losses within 1e-4
  relative and parameters and moments within 1e-4 of the largest entry,
  because JAX under x64 draws the acting noise without a dtype
  (``ppo.py:113``) and so acts, stores the actions and log-probs, and runs
  the surrogate in float64 where the port stays in float32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gym_rotor_tpu.algos import ppo as jppo
from gym_rotor_tpu.envs import batch as jbatch
from gym_rotor_tpu.models import mlp as jmlp
from gym_rotor_tpu.models import zoo as jmodels
from gym_rotor_tpu.models.emlp import zoo as jzoo
from gym_rotor_tpu.parallel import mesh as jmesh
from gym_rotor_tpu.parallel.train_step import (init_ep_ret,
                                               make_sharded_ppo_superstep,
                                               sharded_init)
from gym_rotor_tpu_torch import Config as TConfig
from gym_rotor_tpu_torch import convert
from gym_rotor_tpu_torch.algos import ppo as tppo
from gym_rotor_tpu_torch.envs import draws as D
from gym_rotor_tpu_torch.evaluate import joint_policy
from gym_rotor_tpu_torch.kernels import emlp_actor as kactor
from gym_rotor_tpu_torch.kernels import gae as K12
from gym_rotor_tpu_torch.kernels import ppo_loss as K13
from gym_rotor_tpu_torch.kernels.env_tick import TickLoop
from gym_rotor_tpu_torch.models import mlp as tmlp
from gym_rotor_tpu_torch.models.emlp import zoo as tzoo
from gym_rotor_tpu_torch.parallel.train_step import make_ppo_superstep
from test_torch_env import _tick_draws
from test_torch_td3 import (AGENTS, _adam, _cfgs, _close, _np, _np_tree,
                            _schedule, _t, _to64)
from torch_jax_fixtures import jit_bases_as_args

torch.set_num_threads(1)
PPO = dict(rl_algo="PPO", num_envs=4, T_horizon=16, actor_batch_size=4,
           critic_batch_size=4, K_epochs=2)


def _ppo_cfgs(**kw):
    return _cfgs(**{**PPO, **kw})


# ---------------------------------------------------------------------------
# K12: GAE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,B", [(5, 3), (1, 4), (1, 1)])
def test_gae_matches_jax(T, B):
    """``ppo.gae`` (K12's plain twin) vs ``ppo_lib.gae`` on a (T, B, 1)
    horizon with dones inside it, at T = 1 and at n = T B = 1 (the
    ``max(n - 1, 1)`` edge, where the std is 0), float64."""
    jcfg, tcfg = _ppo_cfgs()
    rng = np.random.default_rng(T * 10 + B)
    v, nv, r = (rng.normal(size=(T, B, 1)) for _ in range(3))
    d = (rng.uniform(size=(T, B, 1)) < 0.3).astype(np.float64)
    if T > 2:
        d[1, 0, 0], d[2, 0, 0] = 1.0, 0.0          # a reset inside the chain
    ja, jt = jppo.gae(jcfg, *map(jnp.asarray, (v, nv, r, d)))
    ta, tt = tppo.gae(tcfg, *map(_t, (v, nv, r, d)))
    before = K12.gae.launches
    _close(_np(ta), ja, 1e-12, "advantages")
    _close(_np(tt), jt, 1e-12, "td targets")
    assert K12.gae.launches == before
    if T * B == 1:
        assert float(ta) == 0.0


def test_gae_chain_is_cut_by_done():
    """A done at tick t stops the recursion: the advantage at t is its own
    delta, whatever follows (before the normalisation), and each env
    column's chain is its own."""
    T, B = 4, 2
    gen = torch.Generator().manual_seed(3)
    v, nv, r = (torch.randn(T, B, 1, generator=gen, dtype=torch.float64)
                for _ in range(3))
    d = torch.zeros(T, B, 1, dtype=torch.float64)
    d[1, 0] = 1.0
    _, td = K12.gae_plain(v, nv, r, d, 0.99, 0.9)
    assert float(td[1, 0] - v[1, 0]) == pytest.approx(float(r[1, 0] - v[1, 0]),
                                                      abs=1e-15)
    r2 = r.clone()
    r2[2:, 0] += 5.0
    _, td2 = K12.gae_plain(v, nv, r2, d, 0.99, 0.9)
    assert torch.equal(td[:2, 0], td2[:2, 0])
    assert torch.equal(td[:, 1], td2[:, 1])
    r3 = r.clone()
    r3[2:, 1] += 5.0                          # column 1 has no done
    _, td3 = K12.gae_plain(v, nv, r3, d, 0.99, 0.9)
    assert (td3[:2, 1] > td[:2, 1] + 1.0).all()
    assert torch.equal(td3[:, 0], td[:, 0])


# ---------------------------------------------------------------------------
# The networks
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _flax_ppo(agent_id):
    jcfg, _ = _ppo_cfgs()
    defs = jzoo.ppo_models(jcfg, agent_id)
    obs = jnp.zeros((1, jcfg.obs_dim_n[agent_id]))
    return (defs.actor_def,
            defs.actor_def.init(jax.random.PRNGKey(7 + agent_id), obs),
            defs.critic_def,
            defs.critic_def.init(jax.random.PRNGKey(9 + agent_id), obs))


@pytest.mark.parametrize("agent_id", AGENTS)
def test_ppo_layouts_match_flax(agent_id):
    """``EMLPActorPPO``'s and ``EMLPVCritic``'s names, shapes and flat order
    equal flax's ``ravel_pytree`` order (``log_std`` first), the converters
    fill them leaf for leaf, and the spectral widths are JAX's."""
    jcfg, tcfg = _ppo_cfgs()
    agent = tppo.PPOAgent(tcfg, agent_id, "cpu")
    _, aparams, _, cparams = _flax_ppo(agent_id)
    for params, layout, conv, widths in (
            (aparams, agent.actor_layout, convert.ppo_actor_params_from_jax,
             agent.actor_widths),
            (cparams, agent.critic_layout, convert.v_critic_params_from_jax,
             agent.critic_widths)):
        leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
        names = [".".join(k.key for k in path) for path, _ in leaves]
        assert names == layout.names
        assert [tuple(v.shape) for _, v in leaves] == layout.shapes
        flat = convert.flat_from_jax(_np_tree(params), layout, "cpu")
        np.testing.assert_array_equal(_np(flat),
                                      np.asarray(ravel_pytree(params)[0]))
        sd = conv(_np_tree(params), tcfg, agent_id)
        assert {n: tuple(v.shape) for n, v in sd.items()} == dict(
            zip(layout.names, layout.shapes))
        assert widths == [int(w.shape[1]) for w in jax.tree.leaves(
            jzoo.spectral_weights(params)[0])]
    assert agent.actor_layout.names[0] == "log_std"
    assert agent.actor_layout.shapes[0] == (1, tcfg.action_dim_n[agent_id])
    jreps = jzoo.v_critic_reps(jcfg, "MODUL", agent_id, "DTDE")
    treps = tzoo.v_critic_reps(tcfg, "MODUL", agent_id, "DTDE")
    assert [r.size for r in treps] == [r.size for r in jreps]


@pytest.mark.parametrize("agent_id", AGENTS)
def test_ppo_networks_match_flax(agent_id):
    """Flax's ``EMLPActorPPO`` ``(mean, log_std)`` and ``EMLPVCritic`` with
    the carried params and ``log_std`` moved off 0, float64: the
    structured ``dist`` and V within 1e-12, the training path's
    ``dist_f`` and ``critic_apply`` within 1e-9."""
    _, tcfg = _ppo_cfgs()
    amod, aparams, cmod, cparams = _flax_ppo(agent_id)
    aparams = _to64(aparams)
    aparams["params"]["log_std"] = jnp.linspace(
        -0.7, 0.4, tcfg.action_dim_n[agent_id])[None]
    cparams = _to64(cparams)
    rng = np.random.default_rng(20 + agent_id)
    obs = rng.normal(0, 0.6, (24, tcfg.obs_dim_n[agent_id]))
    jm, jl = amod.apply(aparams, jnp.asarray(obs))
    jv = cmod.apply(cparams, jnp.asarray(obs))
    actor = tzoo.EMLPActorPPO(*tzoo.actor_reps(tcfg, "MODUL", agent_id),
                              tcfg.action_dim_n[agent_id], device="cpu",
                              dtype=torch.float64)
    actor.load_state_dict(convert.ppo_actor_params_from_jax(
        _np_tree(aparams), tcfg, agent_id))
    critic = tzoo.EMLPVCritic(*tzoo.v_critic_reps(tcfg, "MODUL", agent_id,
                                                  "DTDE"),
                              device="cpu", dtype=torch.float64)
    critic.load_state_dict(convert.v_critic_params_from_jax(
        _np_tree(cparams), tcfg, agent_id))
    with torch.no_grad():
        tm, tl = actor.dist(_t(obs))
        tv = critic(_t(obs))
    _close(_np(tm), jm, 1e-12, "mean")
    _close(_np(tl), jl, 1e-12, "log_std")
    _close(_np(tv), jv, 1e-12, "V")
    agent = tppo.PPOAgent(tcfg, agent_id, "cpu", torch.float64)
    af = convert.flat_from_jax(_np_tree(aparams), agent.actor_layout, "cpu",
                               torch.float64)
    cf = convert.flat_from_jax(_np_tree(cparams), agent.critic_layout, "cpu",
                               torch.float64)
    fm, fl = agent.dist_f(agent.actor_layout.views(af), _t(obs))
    fv = agent.critic_apply(agent.critic_layout.views(cf), _t(obs))
    _close(_np(fm), jm, 1e-9, "dist_f mean")
    _close(_np(fl), jl, 1e-9, "dist_f log_std")
    _close(_np(fv), jv, 1e-9, "critic_apply V")


@pytest.mark.parametrize("agent_id", AGENTS)
@pytest.mark.parametrize("is_eval", [False, True])
def test_acting_matches_choose_action(agent_id, is_eval):
    """The acting path (K11's plain twin through ``PPOAgent.choose_action``)
    vs ``PPOAgent.choose_action_f`` with JAX's own noise, float64, in train
    mode (the clipped draw and the log-prob of the clipped action, with
    ``log_std`` large enough that some actions clip) and eval mode
    (``clip(mean)`` and zeros); the eval mode is also what
    ``evaluate.joint_policy`` acts with."""
    jcfg, tcfg = _ppo_cfgs()
    jagent = jppo.PPOAgent(jcfg, agent_id, jzoo.ppo_models(jcfg, agent_id))
    _, aparams, _, _ = _flax_ppo(agent_id)
    aparams = _to64(aparams)
    aparams["params"]["log_std"] = jnp.full(
        (1, tcfg.action_dim_n[agent_id]), 0.3)
    rng = np.random.default_rng(40 + agent_id)
    obs = rng.normal(0, 0.6, (32, tcfg.obs_dim_n[agent_id]))
    key = jax.random.PRNGKey(41)
    ja, jl = jagent.choose_action_f(aparams, jnp.asarray(obs), key, is_eval)
    noise = jax.random.normal(key, ja.shape, jnp.float64)
    agent = tppo.PPOAgent(tcfg, agent_id, "cpu", torch.float64)
    flat = convert.flat_from_jax(_np_tree(aparams), agent.actor_layout, "cpu",
                                 torch.float64)
    st = agent.make_state(flat, torch.zeros(agent.critic_layout.size))
    before = kactor.ppo_actor.launches
    out = torch.full((32, agent.action_dim), 7.0, dtype=torch.float64)
    logp = torch.full_like(out, 7.0)
    ta, tl = agent.choose_action(st, _t(obs), None if is_eval else _t(noise),
                                 out=out, logp=logp)
    assert ta is out and tl is logp
    _close(_np(ta), ja, 1e-12, "action")
    _close(_np(tl), jl, 1e-12, "logp")
    if is_eval:
        assert not _np(tl).any()
        joint = joint_policy([agent.actor_net])((_t(obs),))   # float32 out
        _close(_np(joint), ja, 1e-7, "joint_policy")
    else:
        assert (np.abs(_np(ta)) == 1.0).any()
    assert kactor.ppo_actor.launches == before


def test_ppo_fold_packs_the_log_std():
    """K11's folded image holds K3's sections (blocks, mean head) and the
    ``log_std`` parameter; the cache refolds after the flat optimizer's
    write bumps the version."""
    _, tcfg = _ppo_cfgs()
    agent = tppo.PPOAgent(tcfg, 0, "cpu")
    st = agent.init(torch.Generator().manual_seed(2))
    actor = agent.actor_net
    f1 = kactor.fold_actor(actor)
    nin, ng, nh, nact = f1["dims"]
    assert (nin, nh, nact) == (15, tcfg.actor_hidden_dim[0], 4)
    torch.testing.assert_close(kactor.section(f1, "log_std", nact),
                               actor.log_std.reshape(-1), rtol=0, atol=0)
    Wh, bh = f1["head"]
    torch.testing.assert_close(kactor.section(f1, "bh", nact), bh,
                               rtol=0, atol=0)
    grad = torch.ones(st.actor.shape)
    st.actor_opt = agent.actor_tx.update(st.actor, grad, st.actor_opt,
                                         owner=actor)
    f2 = kactor.fold_actor(actor)
    assert f2 is not f1
    assert not torch.equal(kactor.section(f2, "log_std", nact),
                           kactor.section(f1, "log_std", nact))


# ---------------------------------------------------------------------------
# K13: the clipped surrogate
# ---------------------------------------------------------------------------
def _jax_surrogate(mean, log_std, a, lp_old, ad, coef, clip_rate):
    """``ppo.py:247-258``'s surrogate, as written there."""
    log_std = jnp.broadcast_to(log_std, mean.shape)
    entropy = jnp.sum(jmlp.gaussian_entropy(log_std), axis=-1, keepdims=True)
    lp = jmlp.gaussian_logprob(mean, log_std, a)
    ratio = jnp.exp(lp.sum(-1, keepdims=True) - lp_old.sum(-1, keepdims=True))
    s1 = ratio * ad
    s2 = jnp.clip(ratio, 1.0 - clip_rate, 1.0 + clip_rate) * ad
    return -(jnp.minimum(s1, s2) + coef * entropy).mean()


_jax_ratio = jax.jit(lambda m, s, a, lo: jnp.exp(
    jmlp.gaussian_logprob(m, jnp.broadcast_to(s, m.shape), a).sum(-1)
    - lo.sum(-1)))


def _k13_inputs(act, seed=0):
    """Rows of every kind, float64: 24 with ratios spread over
    [exp(-0.6), exp(0.6)] (inside and outside the clip range on both sides)
    and advantages of both signs, 4 with a zero advantage; for ``act == 1``
    also 4 rows exactly at ``1 + 0.2`` and 4 exactly at ``1 - 0.2`` (the
    log-prob's ``log_std`` is 0, so ``std`` is exactly 1, and ``lp_old`` is
    moved by ulps until both JAX's and torch's ratio land on the bound)."""
    rng = np.random.default_rng(seed)
    n = 36 if act == 1 else 28
    m = rng.normal(0, 0.4, (n, act))
    ls = rng.uniform(-0.5, 0.3, act) if act > 1 else np.zeros(act)
    a = m + rng.normal(0, 0.5, (n, act))
    lp = -0.5 * ((a - m) / np.exp(ls)) ** 2 - ls - tmlp.HALF_LOG_2PI
    lp_old = lp - rng.uniform(-0.6, 0.6, (n, act)) / act
    adv = rng.normal(size=(n, 1))
    adv[24:28] = 0.0
    if act == 1:
        for rows, bound in ((slice(28, 32), 1.2), (slice(32, 36), 0.8)):
            for r in range(rows.start, rows.stop):
                lp_old[r, 0] = _at_bound(m[r], ls, a[r], bound)
    return m, ls, a, lp_old, adv


def _at_bound(m, ls, a, bound):
    """An ``lp_old`` for the one-action row ``(m, ls, a)``, with ``a`` set
    to ``m + 0.1`` and moved in steps of 1e-3 where needed, at which JAX's
    and torch's ratio both equal ``bound`` exactly (XLA's and torch's
    ``exp`` differ by an ulp on some arguments, and near 1.2 XLA's misses
    the bound for every ``lp_old`` once ``|a - m|`` is large).  Writes the
    chosen action into ``a``."""
    acts = m[0] + 0.1 + 1e-3 * np.repeat(np.arange(50), 7)
    lp = -0.5 * (acts - m[0]) ** 2 - tmlp.HALF_LOG_2PI
    x = lp - np.log(bound)
    x = x + np.tile(np.arange(-3, 4), 50) * np.abs(np.spacing(x))
    args = (np.full((350, 1), m[0]), ls, acts[:, None], x[:, None])
    jr = np.asarray(_jax_ratio(*map(jnp.asarray, args)))
    tr = _np(K13._ratio(*map(_t, args))[0])[:, 0]
    hit = np.flatnonzero((jr == bound) & (tr == bound))
    assert hit.size, f"no lp_old puts the row at {bound}"
    a[0] = acts[hit[0]]
    return x[hit[0]]


@pytest.mark.parametrize("act", [4, 1])
def test_ppo_surrogate_matches_jax(act):
    """``ppo_loss_plain`` and ``ppo_loss_backward_plain`` vs
    ``jax.value_and_grad`` of the surrogate with respect to ``mean`` and
    ``log_std``, float64, on every row kind of ``_k13_inputs`` (ties inside
    the clip range, at a zero advantage, and at both clip bounds)."""
    m, ls, a, lp_old, adv = _k13_inputs(act)
    coef = np.float32(0.0097)
    f = functools.partial(_jax_surrogate, a=jnp.asarray(a),
                          lp_old=jnp.asarray(lp_old), ad=jnp.asarray(adv),
                          coef=jnp.asarray(coef), clip_rate=0.2)
    jl, (jgm, jgs) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(m), jnp.asarray(ls)[None])
    tc = torch.tensor(coef)
    tl = K13.ppo_loss_plain(*map(_t, (m, ls, a, lp_old, adv)), tc, 0.2)
    g = torch.tensor(1.0, dtype=torch.float64)
    tgm, tgs = K13.ppo_loss_backward_plain(g, *map(_t, (m, ls[None], a,
                                                        lp_old, adv)), tc,
                                           0.2)
    _close(float(tl), float(jl), 1e-12, "loss")
    _close(_np(tgm), jgm, 1e-12, "g_mean")
    _close(_np(tgs), jgs, 1e-12, "g_log_std")
    ratio = _np(K13._ratio(*map(_t, (m, ls, a, lp_old)))[0])[:, 0]
    assert (ratio > 1.2).any() and (ratio < 0.8).any()
    assert ((ratio > 0.8) & (ratio < 1.2)).any()
    if act == 1:
        assert (ratio[28:32] == 1.2).all() and (ratio[32:36] == 0.8).all()
        # at the bound the clip passes half: the rows' gradient is 3/4 (or
        # 1/4) of the unclipped one where s2 is the minimum
        assert np.abs(_np(tgm)[28:36]).min() > 0.0


def test_ppo_surrogate_autograd_uses_the_hand_backward():
    """``ppo_surrogate`` under autograd: the value of ``ppo_loss_plain``,
    the gradients of ``ppo_loss_backward_plain`` scaled by the loss's
    cotangent, ``log_std`` (1, act) in and out, and no launch counted on
    CPU tensors."""
    m, ls, a, lp_old, adv = _k13_inputs(1, seed=1)
    mt = _t(m).requires_grad_(True)
    st = _t(ls[None]).requires_grad_(True)
    coef = torch.tensor(0.01)
    before = (K13.ppo_loss.launches, K13.ppo_loss_backward.launches)
    loss = K13.ppo_surrogate(mt, st, _t(a), _t(lp_old), _t(adv), coef, 0.2)
    (3.0 * loss).backward()
    ref = K13.ppo_loss_plain(_t(m), _t(ls), _t(a), _t(lp_old), _t(adv),
                             coef, 0.2)
    rgm, rgs = K13.ppo_loss_backward_plain(
        torch.tensor(3.0, dtype=torch.float64), _t(m), _t(ls[None]), _t(a),
        _t(lp_old), _t(adv), coef, 0.2)
    assert torch.equal(loss.detach(), ref)
    assert torch.equal(mt.grad, rgm) and torch.equal(st.grad, rgs)
    assert st.grad.shape == (1, 1)
    assert (K13.ppo_loss.launches, K13.ppo_loss_backward.launches) == before


# ---------------------------------------------------------------------------
# One update
# ---------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _epoch_draw_arrays(key, shapes, rows, k_epochs, jdtype):
    """``train_step``'s draws from its key (ppo.py:158, :225-228, :316;
    regularizers.py:55, :129): per agent of ``shapes`` ``(obs, actor
    widths, critic widths)``, per epoch the permutation, the CAPS draw and
    both networks' start vectors from the one ``k_spec``."""
    out = []
    for obs, aws, cws in shapes:
        key, sub = jax.random.split(key)
        epochs = []
        for ek in jax.random.split(sub, k_epochs):
            k_perm, k_caps, k_spec = jax.random.split(ek, 3)

            def starts(widths):
                return tuple(jax.random.normal(jax.random.fold_in(k_spec, j),
                                               (w,), jdtype)
                             for j, w in enumerate(widths))
            epochs.append((jax.random.permutation(k_perm, rows),
                           jax.random.normal(k_caps, (1, obs), jdtype),
                           starts(aws), starts(cws)))
        out.append(epochs)
    return out


def _epoch_draws(key, agents, rows, k_epochs, dtype, jdtype):
    shapes = tuple((a.obs_dim, tuple(a.actor_widths), tuple(a.critic_widths))
                   for a in agents)
    return tuple(
        tuple(D.PPOEpochDraws(_t(p).long(), _t(c, dtype),
                              tuple(_t(x, dtype) for x in aw),
                              tuple(_t(x, dtype) for x in cw))
              for p, c, aw, cw in epochs)
        for epochs in _epoch_draw_arrays(key, shapes, rows, k_epochs, jdtype))


def _learner_to64(st):
    """Parameters and their optimizer states in float64; ``entropy_coef``
    stays float32, as JAX keeps it."""
    return st.replace(actor=_to64(st.actor), critic=_to64(st.critic),
                      actor_opt=_to64(st.actor_opt),
                      critic_opt=_to64(st.critic_opt))


@functools.lru_cache(maxsize=None)
def _jax_learner(bases_as_args=False, **kw):
    """JAX agents of ``_ppo_cfgs(**kw)``, float64 states and the jitted
    ``train_step`` (with ``bases_as_args``, the large EMLP bases passed to
    XLA as arguments: ``torch_jax_fixtures.jit_bases_as_args``)."""
    jcfg, tcfg = _ppo_cfgs(**kw)
    agents = [jppo.PPOAgent(jcfg, i, jmodels.ppo_models(jcfg, i))
              for i in range(jcfg.n_agents)]
    states = [_learner_to64(a.init(jax.random.PRNGKey(20 + i)))
              for i, a in enumerate(agents)]
    step = (jit_bases_as_args if bases_as_args else jax.jit)(
        lambda st, d, k: jppo.train_step(jcfg, agents, st, d, k))
    return jcfg, tcfg, agents, states, step


def _horizon(rng, cfg):
    """A (T, B, .) horizon per agent, float64, with dones inside it and
    log-probs near the policy's."""
    T, B = cfg.T_horizon // cfg.num_envs, cfg.num_envs

    def per_agent(f):
        return tuple(f(d) for d in zip(cfg.obs_dim_n, cfg.action_dim_n))
    obs = per_agent(lambda d: rng.normal(0, 0.5, (T, B, d[0])))
    act = per_agent(lambda d: rng.uniform(-1, 1, (T, B, d[1])))
    rwd = per_agent(lambda d: rng.uniform(-1, 1, (T, B, 1)))
    nxt = per_agent(lambda d: rng.normal(0, 0.5, (T, B, d[0])))
    done = per_agent(lambda d: (rng.uniform(size=(T, B, 1)) < 0.2)
                     .astype(np.float64))
    logp = per_agent(lambda d: rng.uniform(-1.6, -0.9, (T, B, d[1])))
    fields = (obs, act, rwd, nxt, done, logp)
    return (jppo.Horizon(*(tuple(map(jnp.asarray, f)) for f in fields)),
            tppo.Horizon(*(tuple(map(_t, f)) for f in fields)))


def _compare_ppo(tst, jst, rel, what):
    for name in ("actor", "critic"):
        _close(_np(getattr(tst, name)), ravel_pytree(getattr(jst, name))[0],
               rel, f"{what} {name}")
    for name in ("actor_opt", "critic_opt"):
        t, j = getattr(tst, name), getattr(jst, name)
        _close(_np(t.mu), _adam(j).mu, rel, f"{what} {name}.mu")
        _close(_np(t.nu), _adam(j).nu, rel, f"{what} {name}.nu")
        assert t.count == int(_adam(j).count)
        assert t.sched_count == int(_schedule(j).count)
    assert tst.entropy_coef.dtype == torch.float32
    assert jst.entropy_coef.dtype == jnp.float32
    assert float(tst.entropy_coef) == float(jst.entropy_coef)
    assert tst.total_it == int(jst.total_it)


def test_train_step_matches_jax():
    """One ``train_step`` for both agents from the same state, horizon and
    draws (16 rows, 2 epochs of 4 actor and 4 critic minibatches each):
    losses, both networks, ``mu``/``nu``, the counts, ``entropy_coef`` and
    ``total_it``, float64 (``entropy_coef`` float32, as in JAX).  The
    states come from JAX after one update through ``ppo_state_from_jax``."""
    train_step_vs_jax()


def train_step_vs_jax(**kw):
    """The check of ``test_train_step_matches_jax`` for ``_ppo_cfgs(**kw)``."""
    jcfg, tcfg, jagents, jstates, jstep = _jax_learner(**kw)
    agent_ids = range(jcfg.n_agents)
    rng = np.random.default_rng(30)
    jd, _ = _horizon(rng, jcfg)
    jstates, _ = jstep(jstates, jd, jax.random.PRNGKey(40))
    tagents = [tppo.PPOAgent(tcfg, i, "cpu", torch.float64)
               for i in agent_ids]
    tstates = [convert.ppo_state_from_jax(_np_tree(s), a)
               for s, a in zip(jstates, tagents)]
    for ts, js in zip(tstates, jstates):
        _compare_ppo(ts, js, 0.0, "converted")
    jd, td = _horizon(rng, jcfg)
    key = jax.random.PRNGKey(50)
    jnew, jm = jstep(jstates, jd, key)
    draws = _epoch_draws(key, tagents, jcfg.T_horizon, jcfg.K_epochs,
                         torch.float64, jnp.float64)
    tstates, tm = tppo.train_step(tcfg, tagents, tstates, td, draws)
    assert set(tm) == set(jm)
    for i in agent_ids:
        for k in ("actor_loss", "critic_loss"):
            _close(float(tm[f"agent{i}/{k}"]), float(jm[f"agent{i}/{k}"]),
                   1e-9, f"agent {i} {k}")
        _compare_ppo(tstates[i], jnew[i], 1e-9, f"agent {i}")
        assert tstates[i].total_it == 2


def test_convert_ppo_state_round_trip():
    """``ppo_state_from_jax`` lays both networks out in ``ravel_pytree``
    order: the port's flat vectors unravel into JAX's trees, its views by
    name are the flax leaves, the actor module is a view of the state's
    vector, and the optax states, ``entropy_coef`` (float32) and
    ``total_it`` carry."""
    jcfg, tcfg, jagents, jstates, jstep = _jax_learner()
    rng = np.random.default_rng(31)
    jd, _ = _horizon(rng, jcfg)
    jstates, _ = jstep(jstates, jd, jax.random.PRNGKey(45))
    for i, js in enumerate(jstates):
        agent = tppo.PPOAgent(tcfg, i, "cpu", torch.float64)
        ts = convert.ppo_state_from_jax(_np_tree(js), agent)
        for name, layout in (("actor", agent.actor_layout),
                             ("critic", agent.critic_layout)):
            jtree = getattr(js, name)
            back = ravel_pytree(jtree)[1](jnp.asarray(_np(getattr(ts, name))))
            jax.tree.map(np.testing.assert_array_equal, back, jtree)
            for n, v in layout.views(getattr(ts, name)).items():
                ref = jtree["params"]
                for part in n.split("."):
                    ref = ref[part]
                np.testing.assert_array_equal(_np(v), np.asarray(ref),
                                              err_msg=n)
        _compare_ppo(ts, js, 0.0, f"agent {i}")
        assert ts.total_it == 1 and ts.actor_opt.count == 2 * 4
        f32 = np.float32
        assert float(ts.entropy_coef) == float(
            f32(tcfg.entropy_coef) * f32(tcfg.entropy_coef_decay))
        assert agent.actor_net.log_std.data_ptr() == ts.actor.data_ptr()


def test_ppo_epoch_draws_shapes():
    """``make_ppo_epoch_draws``: per agent and epoch a permutation of the
    horizon's rows, the CAPS draw and one start vector per regularized
    weight of each network."""
    _, tcfg = _ppo_cfgs()
    agents = [tppo.PPOAgent(tcfg, i, "cpu") for i in AGENTS]
    ed = D.make_ppo_epoch_draws(
        16, 3, tcfg.obs_dim_n, [a.actor_widths for a in agents],
        [a.critic_widths for a in agents], torch.Generator().manual_seed(0),
        "cpu")
    assert len(ed) == 2 and all(len(e) == 3 for e in ed)
    for a, epochs in zip(agents, ed):
        for d in epochs:
            assert sorted(d.perm.tolist()) == list(range(16))
            assert d.caps_eps.shape == (1, a.obs_dim)
            assert [s.shape[0] for s in d.actor_starts] == a.actor_widths
            assert [s.shape[0] for s in d.critic_starts] == a.critic_widths
        assert not torch.equal(epochs[0].perm, epochs[1].perm)


# ---------------------------------------------------------------------------
# Supersteps
# ---------------------------------------------------------------------------
def test_ppo_superstep_matches_jax():
    """2 supersteps (a horizon of 4 ticks of 4 envs, 2 epochs) against
    ``make_sharded_ppo_superstep`` on a 1-device CPU mesh, float32 as JAX
    runs it, from the same envs and learner states and with JAX's draws:
    each tick's env draws and acting noise (the rollout replayed on the
    JAX side to reach each tick's keys) and the epoch draws, rebuilt from
    the superstep's key."""
    ppo_superstep_vs_jax()


def ppo_superstep_vs_jax(**kw):
    """The check of ``test_ppo_superstep_matches_jax`` for
    ``_ppo_cfgs(max_steps=3, **kw)``."""
    jcfg, tcfg = _ppo_cfgs(max_steps=3, **kw)
    agent_ids = range(jcfg.n_agents)
    mesh = jmesh.make_mesh(1)
    jagents = [jppo.PPOAgent(jcfg, i, jmodels.ppo_models(jcfg, i))
               for i in agent_ids]
    jstates = [jax.device_put(a.init(jax.random.PRNGKey(60 + i)),
                              jmesh.replicated(mesh))
               for i, a in enumerate(jagents)]
    jbs, jobs, _ = sharded_init(jcfg, mesh, jax.random.PRNGKey(61),
                                with_replay=False)
    jep = init_ep_ret(jcfg, mesh)
    rl = jcfg.T_horizon // jcfg.num_envs
    jstep = make_sharded_ppo_superstep(jcfg, jagents, mesh, rollout_len=rl)

    tagents = [tppo.PPOAgent(tcfg, i, "cpu") for i in agent_ids]
    tstates = [convert.ppo_state_from_jax(_np_tree(s), a)
               for s, a in zip(jstates, tagents)]
    loop = TickLoop(tcfg, convert.env_state_from_numpy(_np_tree(jbs),
                                                       device="cpu"))
    tobs = tuple(_t(o) for o in jobs)
    buf = tppo.HorizonBuffer(tcfg, rl, "cpu")
    tep = torch.zeros(tcfg.num_envs, tcfg.n_agents)
    tstep = make_ppo_superstep(tcfg, tagents, "cpu", rollout_len=rl)
    draws_fn = jax.jit(lambda b: _tick_draws(b, jnp.float32))

    @jax.jit
    def replay_tick(bs, ob, states, k):
        """One tick of the superstep's scan body: the acting noise and the
        next env state (train_step.py:252-264)."""
        acts, noise = [], []
        for i, a in enumerate(jagents):
            k, sub = jax.random.split(k)
            act, _ = a.choose_action_f(a.fold_actor(states[i].actor), ob[i],
                                       sub)
            acts.append(act)
            noise.append(jax.random.normal(sub, act.shape))
        bs, out = jbatch.batched_step(jcfg, bs, jnp.concatenate(acts, -1))
        return bs, out.obs, tuple(noise)

    resets = 0
    for s in range(2):
        key = jax.random.PRNGKey(70 + s)
        k_roll, k_upd = jax.random.split(jax.random.fold_in(key, 0))
        ticks, bs, ob = [], jbs, jobs
        for k in jax.random.split(k_roll, rl):
            env = _t(draws_fn(bs))
            bs, ob, noise = replay_tick(bs, ob, jstates, k)
            ticks.append(D.TickDraws(env, tuple(_t(x, torch.float32)
                                                for x in noise)))
        epochs = _epoch_draws(k_upd, tagents, jcfg.T_horizon, jcfg.K_epochs,
                              torch.float32, jnp.float32)
        jbs, jobs, jstates, jep, jm = jstep(jbs, jobs, jstates, jep, key)
        tobs, tm = tstep(loop, tobs, buf, tstates, tep,
                         draws=(ticks, epochs))
        what = f"superstep {s}"
        for a, b in zip(tobs, jobs):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2e-5,
                                       atol=2e-6, err_msg=what)
        np.testing.assert_allclose(_np(tep), np.asarray(jep), rtol=1e-5,
                                   atol=1e-5, err_msg=what)
        np.testing.assert_allclose(float(tm["mean_reward"]),
                                   float(jm["mean_reward"]), rtol=1e-5)
        np.testing.assert_allclose(_np(tm["fin_sum"]),
                                   np.asarray(jm["fin_sum"]), rtol=1e-5,
                                   atol=1e-5)
        assert float(tm["fin_cnt"]) == float(jm["fin_cnt"])
        resets += int(jm["fin_cnt"])
        assert set(tm) == set(jm)
        for i in agent_ids:
            for k in ("actor_loss", "critic_loss"):
                np.testing.assert_allclose(float(tm[f"agent{i}/{k}"]),
                                           float(jm[f"agent{i}/{k}"]),
                                           rtol=1e-4, atol=1e-7,
                                           err_msg=f"{what} agent {i} {k}")
            _compare_ppo(tstates[i], jstates[i], 1e-4, f"{what} agent {i}")
    assert resets > 0
    assert buf.ring.ptr == 0 and buf.ring.filled == jcfg.T_horizon
    return tstates


def test_ppo_train_loop_cpu():
    """``train(Config(rl_algo="PPO"))`` on the CPU at a tiny size: one
    horizon of ``T_horizon // num_envs`` ticks and one update per
    superstep with no warm-up, finite losses, both networks and
    ``entropy_coef`` moving every superstep, the acting modules bound to
    the updated vectors, and no kernel launch."""
    from gym_rotor_tpu_torch.train import train
    tcfg = TConfig(**PPO, max_steps=4, critic_hidden_dim=8,
                   actor_hidden_dim=(8, 4))
    wrappers = [kactor.ppo_actor, K12.gae, K13.ppo_loss,
                K13.ppo_loss_backward]
    before = [w.launches for w in wrappers]
    seen, snaps = [], []

    def probe(i, warm, m, run):
        seen.append((warm, {k: float(v) for k, v in m.items()
                            if k.startswith("agent")}))
        snaps.append([(s.actor.clone(), s.critic.clone(),
                       float(s.entropy_coef)) for s in run["states"]])
    run = train(tcfg, 3, device="cpu", log=None, on_superstep=probe)
    assert [w for w, _ in seen] == [False] * 3
    assert run["total_timesteps"] == 3 * tcfg.T_horizon
    assert run["horizon"].ring.filled == tcfg.T_horizon
    assert [s.total_it for s in run["states"]] == [3, 3]
    assert [s.actor_opt.count for s in run["states"]] == [3 * 2 * 4] * 2
    for _, m in seen:
        assert set(m) == {f"agent{i}/{k}" for i in AGENTS
                          for k in ("actor_loss", "critic_loss")}
        assert all(np.isfinite(v) for v in m.values())
    for k in range(1, 3):
        for (a0, c0, e0), (a1, c1, e1) in zip(snaps[k - 1], snaps[k]):
            assert not torch.equal(a0, a1) and not torch.equal(c0, c1)
            assert e1 < e0
    for agent, st in zip(run["agents"], run["states"]):
        assert agent.actor_net.log_std.data_ptr() == st.actor.data_ptr()
    assert [w.launches for w in wrappers] == before


def test_ppo_constants_match_jax():
    assert tmlp.HALF_LOG_2PI == float(0.5 * jnp.log(2.0 * jnp.pi))
    assert tmlp.HALF_LOG_2PIE == float(0.5 * jnp.log(2.0 * jnp.pi * jnp.e))
    rng = np.random.default_rng(5)
    m, s, a = rng.normal(size=(3, 6, 4))
    _close(_np(tmlp.gaussian_logprob(_t(m), _t(s), _t(a))),
           jmlp.gaussian_logprob(m, s, a), 1e-15, "gaussian_logprob")
    _close(_np(tmlp.gaussian_entropy(_t(s))), jmlp.gaussian_entropy(s),
           1e-15, "gaussian_entropy")
