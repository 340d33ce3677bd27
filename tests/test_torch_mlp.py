"""PyTorch port vs the JAX package: TD3's MLP networks (``ActorTD3``,
``CriticTwin``, ``CriticSingle``, ``critic_twin_split``), their converters,
the model factory's dispatch on ``use_equiv``, and the TD3 update and
superstep with MLP networks (Mono-MLP, Mod-MLP) beside Mono-EMLP.

MLP networks have no kernel of their own (JAX leaves them to XLA's dots;
the port to ``F.linear``), so the CPU path here is the card's path up to
cuBLAS's summation order.  The update's kernels (K6 flat AdamW, K2/K8 ring)
run their plain twins; chip_smoke.py holds the kernels to them on the card.

Tolerances: forwards within 1e-12 of the largest entry (float64), one
update within 1e-9 (float64), the float32 superstep within the bounds of
``test_torch_td3.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gym_rotor_tpu.models import mlp as jmlp
from gym_rotor_tpu.models import zoo as jmodels
from gym_rotor_tpu_torch import convert
from gym_rotor_tpu_torch.algos import td3 as ttd3
from gym_rotor_tpu_torch.algos.common import spectral_widths
from gym_rotor_tpu_torch.kernels import emlp_actor as kactor
from gym_rotor_tpu_torch.models import mlp as tmlp
from gym_rotor_tpu_torch.models import zoo as tmodels
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from test_torch_td3 import (_cfgs, _close, _np_tree, _to64, superstep_vs_jax,
                            train_step_vs_jax)

torch.set_num_threads(1)
MLP = dict(use_equiv=False)
# the three configurations this slice adds beside the flagship Mod-EMLP
CONFIGS = {"mono-emlp": dict(framework="MONO"),
           "mono-mlp": dict(framework="MONO", use_equiv=False),
           "mod-mlp": dict(use_equiv=False)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _flax_pair(jcfg, agent_id, seed):
    """The flax ``ActorTD3``/``CriticTwin`` defs of ``agent_id`` and float64
    params."""
    defs = jmodels.td3_models(jcfg, agent_id)
    obs = jnp.zeros((1, jcfg.obs_dim_n[agent_id]))
    act = jnp.zeros((1, jcfg.action_dim_n[agent_id]))
    ka, kc = jax.random.split(jax.random.PRNGKey(seed))
    return (defs, _to64(defs.actor_def.init(ka, obs)),
            _to64(defs.critic_def.init(kc, obs, act)))


@pytest.mark.parametrize("framework,agent_id",
                         [("MONO", 0), ("MODUL", 0), ("MODUL", 1)])
def test_mlp_layout_matches_flax(framework, agent_id):
    """flax's names, ``(in, out)`` kernels and ``ravel_pytree`` order: the
    port's flat vector of a converted tree unravels into JAX's tree; no
    spectral widths for MLP networks (no Dense kernel is picked up)."""
    jcfg, tcfg = _cfgs(framework=framework, **MLP)
    defs, ap, cp = _flax_pair(jcfg, agent_id, 3)
    agent = ttd3.TD3Agent(tcfg, agent_id, "cpu", torch.float64)
    assert not agent.equivariant
    assert isinstance(agent.actor_net, tmlp.ActorTD3)
    assert isinstance(agent.critic_net, tmlp.CriticTwin)
    for params, layout in ((ap, agent.actor_layout), (cp, agent.critic_layout)):
        flat, unravel = ravel_pytree(params)
        assert layout.size == flat.size
        tflat = convert.flat_from_jax(_np_tree(params), layout, "cpu")
        np.testing.assert_array_equal(_np(tflat), np.asarray(flat))
        jax.tree.map(np.testing.assert_array_equal,
                     unravel(jnp.asarray(_np(tflat))), params)
    assert agent.actor_widths == [] and agent.critic_widths == []
    # what the trap would have been: the raw walk finds the Dense kernels
    assert len(spectral_widths(agent.critic_layout)) == 6


@pytest.mark.parametrize("framework,agent_id",
                         [("MONO", 0), ("MODUL", 0), ("MODUL", 1)])
def test_mlp_networks_match_flax(framework, agent_id):
    """``ActorTD3``, ``CriticTwin`` (both Qs; ``q1`` against the first) and
    ``CriticSingle`` on ``critic_twin_split``'s halves vs flax, float64,
    through the converters (structured modules) and on flat views (the
    training path's functions)."""
    jcfg, tcfg = _cfgs(framework=framework, **MLP)
    defs, ap, cp = _flax_pair(jcfg, agent_id, 4 + agent_id)
    rng = np.random.default_rng(agent_id)
    obs = rng.normal(0, 0.5, (24, jcfg.obs_dim_n[agent_id]))
    act = rng.uniform(-1, 1, (24, jcfg.action_dim_n[agent_id]))
    a_ref = np.asarray(defs.actor_def.apply(ap, jnp.asarray(obs)))
    q_ref = defs.critic_def.apply(cp, jnp.asarray(obs), jnp.asarray(act))
    halves = jmlp.critic_twin_split(cp)
    single = [defs.critic_single.apply(h, jnp.asarray(obs), jnp.asarray(act))
              for h in halves]

    actor, critic = tmodels.td3_models(tcfg, agent_id, device="cpu",
                                       dtype=torch.float64)
    actor.load_state_dict(convert.actor_params_from_jax(_np_tree(ap), tcfg,
                                                        agent_id))
    critic.load_state_dict(convert.critic_params_from_jax(_np_tree(cp), tcfg,
                                                          agent_id))
    o, a = _t(obs), _t(act)
    with torch.no_grad():
        _close(_np(actor(o)), a_ref, 1e-12, "actor")
        out = torch.full((24, 7), 9.0, dtype=torch.float64)
        n = actor.action_dim
        actor(o, out=out[:, 2:2 + n])
        _close(_np(out[:, 2:2 + n]), a_ref, 1e-12, "actor into out")
        assert bool((out[:, :2] == 9.0).all())
        for got, ref, what in zip(critic(o, a), q_ref, ("q1", "q2")):
            _close(_np(got), ref, 1e-12, what)
        # (flax cannot apply ``CriticTwin.q1``: it is not ``@compact``;
        # JAX's learner goes through ``critic_twin_split`` instead)
        _close(_np(critic.q1(o, a)), q_ref[0], 1e-12, "q1 method")
        tviews = {n: t for n, t in critic.named_parameters()}
        for k, (h, ref) in enumerate(zip(tmlp.critic_twin_split(tviews),
                                         single)):
            sgl = tmlp.CriticSingle(obs.shape[1] + act.shape[1],
                                    jcfg.critic_hidden_dim, device="cpu",
                                    dtype=torch.float64)
            sgl.load_state_dict(h)
            _close(_np(sgl(o, a)), ref, 1e-12, f"single {k}")
    agent = ttd3.TD3Agent(tcfg, agent_id, "cpu", torch.float64)
    av = agent.actor_layout.views(convert.flat_from_jax(
        _np_tree(ap), agent.actor_layout, "cpu", torch.float64))
    cv = agent.critic_layout.views(convert.flat_from_jax(
        _np_tree(cp), agent.critic_layout, "cpu", torch.float64))
    _close(_np(agent.actor_apply(av, o)), a_ref, 1e-12, "actor_apply")
    for got, ref in zip(agent.critic_apply(cv, o, a), q_ref):
        _close(_np(got), ref, 1e-12, "critic_apply")
    _close(_np(agent.critic_q1(cv, o, a)), single[0], 1e-12, "critic_q1")


def test_mlp_acting_launches_no_kernel_and_reads_bound_params():
    """The MLP actor acts on the views it is bound to (the flat vector the
    optimizer writes in place): a write to the vector shows in the next
    action with no cache to re-key; no kernel wrapper is involved."""
    cfg = TConfig(critic_hidden_dim=8, actor_hidden_dim=(8, 4), **MLP)
    agent = ttd3.TD3Agent(cfg, 0, "cpu")
    st = agent.init(torch.Generator().manual_seed(0))
    obs = torch.randn(5, 15, generator=torch.Generator().manual_seed(1))
    before = (kactor.emlp_actor.launches, kactor.fold_actor.folds)
    a1 = agent.act(st, obs)
    st.actor.data.mul_(1.5)
    a2 = agent.act(st, obs)
    assert not torch.equal(a1, a2)
    torch.testing.assert_close(a2, tmlp.actor_td3(
        agent.actor_layout.views(st.actor), obs), rtol=0, atol=0)
    assert (kactor.emlp_actor.launches, kactor.fold_actor.folds) == before


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_train_step_matches_jax(config, gate):
    """One TD3 ``train_step`` from the same states, batch and draws as JAX,
    with the delayed actor step not taken and taken, for Mono-EMLP,
    Mono-MLP and Mod-MLP: losses, parameters, targets, ``mu``/``nu`` and the
    counts within 1e-9, float64 (``test_torch_td3.py``'s check)."""
    train_step_vs_jax(gate, **CONFIGS[config])


def test_superstep_matches_jax_mono_mlp():
    """2 warm + 3 train Mono-MLP supersteps against the 1-device JAX
    superstep, float32, with JAX's draws."""
    superstep_vs_jax(framework="MONO", **MLP)


def test_train_loop_mod_mlp_cpu():
    """``train`` on the CPU for Mod-MLP at a tiny size: both agents update,
    the exploration noise decays, episodes are logged."""
    from gym_rotor_tpu_torch.train import train
    cfg = TConfig(num_envs=6, max_steps=4, start_timesteps=12, batch_size=8,
                  replay_buffer_size=40, critic_hidden_dim=8,
                  actor_hidden_dim=(8, 4), **MLP)
    run = train(cfg, 6, device="cpu", log=None)
    assert [s.total_it for s in run["states"]] == [4, 4]
    assert run["replay"].data.shape == (40, 45)
    assert run["episodes"] and all(len(r) == 2 for _, r in run["episodes"])
    assert all(not a.equivariant for a in run["agents"])
