"""PyTorch port vs the JAX package: SAC and PPO with the MONO framework and
with MLP networks (Mono-EMLP, Mod-MLP, Mono-MLP): the networks (``ActorSAC``,
``ActorPPO``, ``VCritic`` and the MONO EMLP ones), the acting paths (K9 and
K11 at the MONO actor, the fused MLP PPO actor and K10 on the MLP actors,
through their plain twins), one update of each learner, float32 supersteps and the CPU
training loop.
The CUDA kernels are held to the same twins by chip_smoke.py on the card.

Narrow widths as ``test_torch_td3.py`` (critics of 8, actors of 8 / 4; the
MONO actor 8), random draws JAX's own, rebuilt from its key chain.

Tolerances.  Float64: the structured forwards and the acting draws within
1e-12 of the compared array's largest entry, the training path's within
1e-9 (the EMLP projection once per loss), one update within 1e-9, as for
the MODUL learners.  The float32 supersteps within the bounds of
``test_torch_sac.py`` and ``test_torch_ppo.py`` (JAX under x64 draws the
actor loss's and the acting noise without a dtype, ``sac.py:239-240``,
``ppo.py:113``, and so runs them in float64).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gym_rotor_tpu.algos import ppo as jppo
from gym_rotor_tpu.algos import sac as jsac
from gym_rotor_tpu.models import zoo as jmodels
from gym_rotor_tpu_torch import convert
from gym_rotor_tpu_torch.algos import ppo as tppo
from gym_rotor_tpu_torch.algos import sac as tsac
from gym_rotor_tpu_torch.evaluate import joint_policy
from gym_rotor_tpu_torch.kernels import emlp_actor as kactor
from gym_rotor_tpu_torch.kernels import mlp_ppo_actor as kmlp
from gym_rotor_tpu_torch.kernels import mlp_sac_actor as KMS
from gym_rotor_tpu_torch.kernels import sac_sample as K10
from gym_rotor_tpu_torch.models import mlp as tmlp
from gym_rotor_tpu_torch.models import zoo as tmodels
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from test_torch_ppo import PPO, ppo_superstep_vs_jax
from test_torch_ppo import train_step_vs_jax as ppo_train_step_vs_jax
from test_torch_sac import SAC, _dist_f
from test_torch_sac import train_step_vs_jax as sac_train_step_vs_jax
from test_torch_td3 import _cfgs, _close, _np, _np_tree, _t, _to64
from test_torch_td3 import superstep_vs_jax

torch.set_num_threads(1)
FAMILIES = {"mono-emlp": dict(framework="MONO"),
            "mod-mlp": dict(use_equiv=False),
            "mono-mlp": dict(framework="MONO", use_equiv=False)}
# (family, agent) pairs: every agent of each family
CASES = [("mono-emlp", 0), ("mod-mlp", 0), ("mod-mlp", 1), ("mono-mlp", 0)]
# per algorithm: the port's agent and factory, JAX's agent and factory, and
# the converters of the actor and the critic
ALGOS = {"SAC": (tsac.SACAgent, tmodels.sac_models, jsac.SACAgent,
                 jmodels.sac_models, convert.sac_actor_params_from_jax,
                 convert.critic_params_from_jax),
         "PPO": (tppo.PPOAgent, tmodels.ppo_models, jppo.PPOAgent,
                 jmodels.ppo_models, convert.ppo_actor_params_from_jax,
                 convert.v_critic_params_from_jax)}


def _kw(algo, family):
    fam = {} if family == "mod-emlp" else FAMILIES[family]
    return dict(fam, **(PPO if algo == "PPO" else dict(rl_algo="SAC")))


@functools.lru_cache(maxsize=None)
def _flax(algo, family, agent_id):
    """The flax defs of ``algo``'s agent ``agent_id`` in ``family`` and its
    float64 actor and critic params."""
    jcfg, _ = _cfgs(**_kw(algo, family))
    defs = ALGOS[algo][3](jcfg, agent_id)
    obs = jnp.zeros((1, jcfg.obs_dim_n[agent_id]))
    act = jnp.zeros((1, jcfg.action_dim_n[agent_id]))
    ka, kc = jax.random.split(jax.random.PRNGKey(7 + agent_id))
    cargs = (obs,) if algo == "PPO" else (obs, act)
    return (defs, _to64(defs.actor_def.init(ka, obs)),
            _to64(defs.critic_def.init(kc, *cargs)))


def _agent(algo, family, agent_id, dtype=torch.float64):
    _, tcfg = _cfgs(**_kw(algo, family))
    return tcfg, ALGOS[algo][0](tcfg, agent_id, "cpu", dtype)


# ---------------------------------------------------------------------------
# Networks
# ---------------------------------------------------------------------------
def test_mono_actor_instances_cover_full_width():
    """At full width the MONO SAC and PPO actors are K9 and K11 instances
    (23 obs, 18 gated, 16 hidden, 4 actions) and the MONO V critic's first
    block a K3/K4 instance (23, 71, 62)."""
    from gym_rotor_tpu_torch.kernels import emlp_block as kblock
    for algo, head in (("SAC", kactor.HEAD_GAUSS), ("PPO", kactor.HEAD_PPO)):
        agent = ALGOS[algo][0](TConfig(framework="MONO", rl_algo=algo), 0,
                               "cpu")
        assert kactor.actor_dims(agent.actor_net) == (23, 18, 16, 4)
        assert (23, 18, 16, 4) in kactor.INSTANCES[head]
    v = agent.critic_net.network
    dims = [kblock.block_spec(b, "cpu").dims for b in v.blocks()]
    assert dims == [(23, 71, 62), (62, 71, 62)]
    assert set(dims) <= kblock.INSTANCES


@pytest.mark.parametrize("family,agent_id", CASES)
@pytest.mark.parametrize("algo", list(ALGOS))
def test_layouts_match_flax(algo, family, agent_id):
    """The actor's and the critic's parameter names, shapes and flat order
    equal flax's ``ravel_pytree`` order (the MLP actors' ``Dense_0``,
    ``Dense_1``, ``log_std``, ``mean``), the converters fill them leaf for
    leaf, and the spectral widths are JAX's (none for MLP networks)."""
    tcfg, agent = _agent(algo, family, agent_id, torch.float32)
    defs, ap, cp = _flax(algo, family, agent_id)
    actor_conv, critic_conv = ALGOS[algo][4:]
    for params, layout, conv, widths, spectral in (
            (ap, agent.actor_layout, actor_conv, agent.actor_widths,
             defs.actor_spectral),
            (cp, agent.critic_layout, critic_conv, agent.critic_widths,
             defs.critic_spectral)):
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
        assert widths == ([] if spectral is None else [
            int(w.shape[1]) for w in jax.tree.leaves(spectral(params)[0])])
    assert agent.equivariant == (family == "mono-emlp")
    if not agent.equivariant:
        assert agent.actor_layout.names[:3] == [
            "Dense_0.bias", "Dense_0.kernel", "Dense_1.bias"]
        assert "log_std" in agent.actor_layout.names[4] and \
            agent.actor_layout.names[-1] == "mean.kernel"


@pytest.mark.parametrize("family,agent_id", CASES)
@pytest.mark.parametrize("algo", list(ALGOS))
def test_networks_match_flax(algo, family, agent_id):
    """Flax's actor ``(mean, log_std)`` and critic (SAC's twin Qs, PPO's V)
    with the carried params, float64: the structured modules within 1e-12
    and the training path (``dist_f``/``actor_mean`` and ``critic_apply``
    on flat views) within 1e-9, with SAC's ``log_std`` head scaled so that
    it crosses both clip bounds and PPO's ``log_std`` moved off 0."""
    tcfg, agent = _agent(algo, family, agent_id)
    defs, ap, cp = _flax(algo, family, agent_id)
    ap = jax.tree.map(lambda x: x, ap)
    if algo == "PPO":
        ap["params"]["log_std"] = jnp.linspace(
            -0.7, 0.4, tcfg.action_dim_n[agent_id])[None]
    else:
        head = "log_std" if "log_std" in ap["params"] else "log_std_linear"
        ap["params"][head]["kernel"] = 200.0 * ap["params"][head]["kernel"]
    rng = np.random.default_rng(20 + agent_id)
    obs = rng.normal(0, 0.6, (24, tcfg.obs_dim_n[agent_id]))
    obs[:4] *= 40.0
    act = rng.uniform(-1, 1, (24, tcfg.action_dim_n[agent_id]))
    jm, jl = defs.actor_def.apply(ap, jnp.asarray(obs))
    cargs = (obs,) if algo == "PPO" else (obs, act)
    jc = defs.critic_def.apply(cp, *map(jnp.asarray, cargs))
    jc = (jc,) if algo == "PPO" else jc
    if algo == "SAC":
        lo, hi = float(np.min(jl)), float(np.max(jl))
        assert lo == tmlp.LOG_SIG_MIN and hi == tmlp.LOG_SIG_MAX, (lo, hi)

    _, factory, _, _, actor_conv, critic_conv = ALGOS[algo]
    actor, critic = factory(tcfg, agent_id, device="cpu", dtype=torch.float64)
    actor.load_state_dict(actor_conv(_np_tree(ap), tcfg, agent_id))
    critic.load_state_dict(critic_conv(_np_tree(cp), tcfg, agent_id))
    with torch.no_grad():
        tm, tl = actor.dist(_t(obs))
        tc = critic(*map(_t, cargs))
    tc = (tc,) if algo == "PPO" else tc
    _close(_np(tm), jm, 1e-12, "mean")
    _close(_np(tl), jl, 1e-12, "log_std")
    for got, ref in zip(tc, jc):
        _close(_np(got), ref, 1e-12, "critic")

    av = agent.actor_layout.views(convert.flat_from_jax(
        _np_tree(ap), agent.actor_layout, "cpu", torch.float64))
    cv = agent.critic_layout.views(convert.flat_from_jax(
        _np_tree(cp), agent.critic_layout, "cpu", torch.float64))
    if algo == "SAC":
        fm, fl = _dist_f(agent, av, _t(obs))
        _close(_np(fl), jl, 1e-9, "dist_f log_std")
    else:
        fm = agent.actor_mean(av, _t(obs))
        _close(_np(av["log_std"].expand_as(fm)), jl, 0.0, "log_std")
    _close(_np(fm), jm, 1e-9, "training-path mean")
    fc = agent.critic_apply(cv, *map(_t, cargs))
    fc = (fc,) if algo == "PPO" else fc
    for got, ref in zip(fc, jc):
        _close(_np(got), ref, 1e-9, "critic_apply")


@pytest.mark.parametrize("is_eval", [False, True])
@pytest.mark.parametrize("family,agent_id", CASES)
@pytest.mark.parametrize("algo", list(ALGOS))
def test_acting_matches_choose_action(algo, family, agent_id, is_eval):
    """The acting path through ``choose_action`` (K9 or K11 at the MONO
    actor, the MLP chain with K10's forward, the fused MLP PPO actor: their
    plain twins here) vs JAX ``choose_action_f`` with JAX's own noise, float64,
    written in place into column slices; in train mode (PPO's ``log_std``
    large enough that some actions clip) and eval mode, which is also what
    ``evaluate.joint_policy`` acts with.  No kernel wrapper launches."""
    jcfg, tcfg = _cfgs(**_kw(algo, family))
    defs, ap, _ = _flax(algo, family, agent_id)
    jagent = ALGOS[algo][2](jcfg, agent_id, defs)
    if algo == "PPO":
        ap = jax.tree.map(lambda x: x, ap)
        ap["params"]["log_std"] = jnp.full(
            (1, tcfg.action_dim_n[agent_id]), 0.3)
    rng = np.random.default_rng(40 + agent_id)
    obs = rng.normal(0, 0.6, (32, tcfg.obs_dim_n[agent_id]))
    key = jax.random.PRNGKey(41)
    ref = jagent.choose_action_f(ap, jnp.asarray(obs), key, is_eval)
    ja, jl = ref if algo == "PPO" else (ref, None)
    noise = (jax.random.normal(key, ja.shape, jnp.float64) if algo == "SAC"
             else jax.random.normal(key, ja.shape))
    _, agent = _agent(algo, family, agent_id)
    flat = convert.flat_from_jax(_np_tree(ap), agent.actor_layout, "cpu",
                                 torch.float64)
    st = agent.make_state(flat, torch.zeros(agent.critic_layout.size))
    wrappers = [kactor.sac_actor, kactor.ppo_actor, kmlp.mlp_ppo_actor,
                K10.sac_head, KMS.mlp_sac_actor]
    before = [w.launches for w in wrappers]
    n = agent.action_dim
    out = torch.full((32, n + 2), 7.0, dtype=torch.float64)
    nz = None if is_eval else _t(noise)
    if algo == "PPO":
        logp = torch.full_like(out, 7.0)
        ta, tl = agent.choose_action(st, _t(obs), nz, out=out[:, 1:1 + n],
                                     logp=logp[:, 1:1 + n])
        _close(_np(tl), jl, 1e-12, "logp")
        assert bool((logp[:, 0] == 7.0).all() and (logp[:, -1] == 7.0).all())
        if is_eval:
            assert not _np(tl).any()
        else:
            assert (np.abs(_np(ta)) == 1.0).any()
    else:
        ta = agent.choose_action(st, _t(obs), nz, out=out[:, 1:1 + n])
    _close(_np(ta), ja, 1e-12, "action")
    _close(_np(out[:, 1:1 + n]), ja, 1e-12, "action in place")
    assert bool((out[:, 0] == 7.0).all() and (out[:, -1] == 7.0).all())
    if is_eval:
        joint = joint_policy([agent.actor_net])((_t(obs),))   # float32 out
        _close(_np(joint), ja, 1e-7, "joint_policy")
    assert [w.launches for w in wrappers] == before


def test_ppo_head_plain_twin_matches_jax():
    """K11's head alone (``ppo_head_plain``) on an MLP mean head's output
    vs ``ppo.py:107-116`` with ``mlp.py:173-178``, float64, with
    ``log_std`` per action from -1 to 2.5 (most actions clipped at the
    wide end), and the eval head ``clip(tanh(pre))`` with zero log-probs."""
    from gym_rotor_tpu.models import mlp as jmlp
    rng = np.random.default_rng(3)
    pre = rng.normal(0, 1.5, (64, 4))
    ls = np.array([[-1.0, 0.0, 1.2, 2.5]])
    noise = rng.normal(size=(64, 4))
    mean = jnp.tanh(jnp.asarray(pre))
    ja = jnp.clip(mean + jnp.exp(ls) * noise, -1.0, 1.0)
    jl = jmlp.gaussian_logprob(mean, jnp.broadcast_to(ls, mean.shape), ja)
    ta, tl = kactor.ppo_head_plain(_t(pre), _t(ls), _t(noise))
    _close(_np(ta), ja, 1e-15, "action")
    _close(_np(tl), jl, 1e-12, "logp")
    assert (np.abs(_np(ta[:, 3])) == 1.0).mean() > 0.5
    ea, el = kactor.ppo_head_plain(_t(pre), _t(ls))
    _close(_np(ea), np.clip(np.tanh(pre), -1, 1), 1e-15, "eval action")
    assert not _np(el).any()


# ---------------------------------------------------------------------------
# One update
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sac_train_step_matches_jax(family, gate):
    """One SAC ``train_step`` from the same states, batch and draws as JAX
    (the critic target's Polyak not taken and taken; the temperature
    auto-tuned), float64 within 1e-9 (``test_torch_sac.py``'s check)."""
    sac_train_step_vs_jax(gate, True, **FAMILIES[family])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_ppo_train_step_matches_jax(family):
    """One PPO ``train_step`` (2 epochs of 4 actor and 4 critic
    minibatches) from the same states, horizon and draws as JAX, float64
    within 1e-9 (``test_torch_ppo.py``'s check)."""
    ppo_train_step_vs_jax(**FAMILIES[family])


# ---------------------------------------------------------------------------
# Supersteps and the training entry point
# ---------------------------------------------------------------------------
def test_sac_superstep_matches_jax_mono_emlp():
    """2 warm + 3 train SAC Mono-EMLP supersteps against the 1-device JAX
    superstep with ``train.py``'s SAC hooks, float32, with JAX's draws."""
    superstep_vs_jax(SAC, rl_algo="SAC", framework="MONO")


def test_ppo_superstep_matches_jax_mono_mlp():
    """2 PPO Mono-MLP supersteps (a 4-tick horizon of 4 envs, 2 epochs)
    against ``make_sharded_ppo_superstep``, float32, with JAX's draws."""
    ppo_superstep_vs_jax(framework="MONO", use_equiv=False)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("algo", list(ALGOS))
def test_train_loop_cpu(algo, family):
    """``train`` on the CPU at a tiny size for SAC and PPO in each family:
    every agent updates on every train superstep, the losses stay finite,
    the actor's module is a view of the state's vector, and no kernel
    wrapper launches (every kernel runs its plain twin on the CPU)."""
    from gym_rotor_tpu_torch.train import train
    if algo == "PPO":
        cfg = TConfig(**PPO, max_steps=4, critic_hidden_dim=8,
                      actor_hidden_dim=(8, 4), **FAMILIES[family])
        n, want = 3, 3
    else:
        cfg = TConfig(num_envs=6, max_steps=4, start_timesteps=12,
                      batch_size=8, replay_buffer_size=40, critic_hidden_dim=8,
                      actor_hidden_dim=(8, 4), rl_algo="SAC",
                      **FAMILIES[family])
        n, want = 6, 4
    wrappers = [w for m in (kactor, K10) for w in
                (getattr(m, name) for name in m.WRAPPERS)]
    before = [w.launches for w in wrappers]
    losses = []
    run = train(cfg, n, device="cpu", log=None,
                on_superstep=lambda i, warm, m, r: losses.extend(
                    float(v) for k, v in m.items() if "loss" in k))
    assert [s.total_it for s in run["states"]] == [want] * cfg.n_agents
    assert losses and all(np.isfinite(losses))
    for agent, st in zip(run["agents"], run["states"]):
        assert agent.equivariant == cfg.use_equiv
        p = next(iter(dict(agent.actor_net.named_parameters()).values()))
        assert st.actor.data_ptr() <= p.data_ptr() < \
            st.actor.data_ptr() + 8 * st.actor.numel()
    assert [w.launches for w in wrappers] == before
