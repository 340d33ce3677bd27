"""PyTorch port vs the JAX package: the CTDE branch of every learner (MATD3,
CTDE SAC and CTDE PPO) with EMLP and MLP networks: the joint critics (the
twin Q over both agents' obs and actions, 18 + 5 = 23 wide; the V critic
over both agents' obs, 18 wide), their K3/K4 first-block shapes at full
width, one update of MATD3 and of CTDE PPO, and the CPU training loop of
each learner (CTDE SAC's update and CTDE PPO's superstep are in
``test_torch_ctde_sac.py``, MATD3's supersteps in ``test_torch_matd3.py``,
so that the files spread over test workers).  The CUDA kernels are held to
the same twins by chip_smoke.py on the card.

Narrow widths as ``test_torch_td3.py`` (critics of 8 hidden channels or
units, actors of 8 / 4, batch 16); random draws JAX's own, rebuilt from its
key chain, each agent's CTDE draws from the ``split`` chains over the
agents (``td3.py:209-221``, ``sac.py:153-160``, ``:212-220``).

Tolerances, as for the DTDE learners: float64 forwards within 1e-12 of the
compared array's largest entry (structured modules) and 1e-9 (the training
path, which projects once per loss), one update within 1e-9.  One update of
agent 1 reads agent 0's updated actor and targets
(JAX's ``train_step`` passes ``new_states`` on), so an update that read the
superstep's starting states would miss the 1e-9 bound.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gym_rotor_tpu.models import zoo as jmodels
from gym_rotor_tpu.models.emlp import zoo as jzoo
from gym_rotor_tpu_torch import convert
from gym_rotor_tpu_torch.algos import ppo as tppo
from gym_rotor_tpu_torch.algos import sac as tsac
from gym_rotor_tpu_torch.algos import td3 as ttd3
from gym_rotor_tpu_torch.envs import draws as D
from gym_rotor_tpu_torch.kernels import emlp_block as kblock
from gym_rotor_tpu_torch.models import zoo as tmodels
from gym_rotor_tpu_torch.models.emlp import zoo as tzoo
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from test_torch_ppo import PPO
from test_torch_ppo import train_step_vs_jax as ppo_train_step_vs_jax
from test_torch_td3 import (AGENTS, _cfgs, _close, _np, _np_tree, _t, _to64,
                            train_step_vs_jax)

torch.set_num_threads(1)
CTDE = dict(module_training="CTDE")
FAMILIES = {"emlp": {}, "mlp": dict(use_equiv=False)}
# the Q critics (TD3's; SAC's are the same networks) and PPO's V critics
KINDS = {"q": (ttd3.TD3Agent, jmodels.td3_models,
               convert.critic_params_from_jax),
         "v": (tppo.PPOAgent, jmodels.ppo_models,
               convert.v_critic_params_from_jax)}


def _kw(kind, family):
    return dict(CTDE, **FAMILIES[family], **(PPO if kind == "v" else {}))


@functools.lru_cache(maxsize=None)
def _flax_critic(kind, family, agent_id):
    """The flax critic of agent ``agent_id`` over the joint input and its
    float64 params."""
    jcfg, _ = _cfgs(**_kw(kind, family))
    mod = KINDS[kind][1](jcfg, agent_id).critic_def
    args = (jnp.zeros((1, sum(jcfg.obs_dim_n))),)
    if kind == "q":
        args += (jnp.zeros((1, sum(jcfg.action_dim_n))),)
    return mod, _to64(mod.init(jax.random.PRNGKey(5 + agent_id), *args))


def _blocks(net):
    return [kblock.block_spec(b, "cpu").dims for b in net.blocks()]


# ---------------------------------------------------------------------------
# The joint critics
# ---------------------------------------------------------------------------
def test_ctde_kernel_instances_cover_full_width():
    """At full width (critics of 62) every CTDE critic block is a K3/K4
    instance: the Q critics' first blocks (23, 71, 62) and (23, 123, 62),
    the V critics' (18, 71, 62) and (18, 123, 62), and the hidden blocks
    the DTDE critics already use; SAC's twin critic is TD3's."""
    cfg = TConfig(**CTDE)
    q_want = {0: [(23, 71, 62), (62, 71, 62)],
              1: [(23, 123, 62), (62, 123, 62)]}
    v_want = {0: [(18, 71, 62), (62, 71, 62)],
              1: [(18, 123, 62), (62, 123, 62)]}
    seen = set()
    for i in AGENTS:
        for cls, algo in ((ttd3.TD3Agent, "TD3"), (tsac.SACAgent, "SAC")):
            critic = cls(cfg.replace(rl_algo=algo), i, "cpu").critic_net
            for net in (critic.network1, critic.network2):
                assert _blocks(net) == q_want[i]
                seen.update(_blocks(net))
        v = tppo.PPOAgent(cfg.replace(rl_algo="PPO"), i, "cpu").critic_net
        assert _blocks(v.network) == v_want[i]
        seen.update(_blocks(v.network))
    assert seen <= kblock.INSTANCES


@pytest.mark.parametrize("agent_id", AGENTS)
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("kind", list(KINDS))
def test_ctde_critic_layout_matches_flax(kind, family, agent_id):
    """The joint critic's reps (EMLP), parameter names, shapes and flat
    order equal flax's ``ravel_pytree`` order, the converter fills them
    leaf for leaf, and the spectral widths are JAX's (none for MLPs)."""
    jcfg, tcfg = _cfgs(**_kw(kind, family))
    agent = KINDS[kind][0](tcfg, agent_id, "cpu")
    assert agent.is_ctde
    mod, params = _flax_critic(kind, family, agent_id)
    if family == "emlp":
        reps = {"q": (jzoo.critic_reps, tzoo.critic_reps),
                "v": (jzoo.v_critic_reps, tzoo.v_critic_reps)}[kind]
        jr = reps[0](jcfg, "MODUL", agent_id, "CTDE")
        tr = reps[1](tcfg, "MODUL", agent_id, "CTDE")
        assert [r.size for r in tr] == [r.size for r in jr]
        assert jr[0].size == (23 if kind == "q" else 18)
    layout = agent.critic_layout
    leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    names = [".".join(k.key for k in path) for path, _ in leaves]
    assert names == layout.names
    assert [tuple(v.shape) for _, v in leaves] == layout.shapes
    flat = convert.flat_from_jax(_np_tree(params), layout, "cpu",
                                 torch.float64)
    np.testing.assert_array_equal(_np(flat),
                                  np.asarray(ravel_pytree(params)[0]))
    sd = KINDS[kind][2](_np_tree(params), tcfg, agent_id)
    assert {n: tuple(v.shape) for n, v in sd.items()} == dict(
        zip(layout.names, layout.shapes))
    spectral = KINDS[kind][1](jcfg, agent_id).critic_spectral
    assert agent.critic_widths == ([] if spectral is None else [
        int(w.shape[1]) for w in jax.tree.leaves(spectral(params)[0])])


@pytest.mark.parametrize("agent_id", AGENTS)
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("kind", list(KINDS))
def test_ctde_critic_matches_flax(kind, family, agent_id):
    """The joint critic on the training path (``critic_apply`` on flat
    views: K3/K4's plain twins for EMLP, ``F.linear`` for MLP) vs flax on
    both agents' obs (and actions): the Qs or V and the gradients with
    respect to the flat parameters and the inputs within 1e-9, float64;
    the structured module through the converter within 1e-12."""
    _, tcfg = _cfgs(**_kw(kind, family))
    agent = KINDS[kind][0](tcfg, agent_id, "cpu", torch.float64)
    mod, params = _flax_critic(kind, family, agent_id)
    rng = np.random.default_rng(10 + agent_id)
    inputs = [rng.normal(0, 0.5, (16, sum(tcfg.obs_dim_n)))]
    if kind == "q":
        inputs.append(rng.uniform(-1, 1, (16, sum(tcfg.action_dim_n))))
    w = rng.normal(size=(2, 16, 1))

    def f(p, *xs):
        out = mod.apply(p, *xs)
        out = out if kind == "q" else (out,)
        return sum(jnp.sum(o * wk) for o, wk in zip(out, w)), out
    argnums = tuple(range(1 + len(inputs)))
    (_, ref), grads = jax.value_and_grad(f, argnums=argnums, has_aux=True)(
        params, *map(jnp.asarray, inputs))
    flat = convert.flat_from_jax(_np_tree(params), agent.critic_layout, "cpu",
                                 torch.float64).requires_grad_(True)
    xs = [_t(x).requires_grad_(True) for x in inputs]
    got = agent.critic_apply(agent.critic_layout.views(flat), *xs)
    got = got if kind == "q" else (got,)
    sum((o * _t(wk)).sum() for o, wk in zip(got, w)).backward()
    for g, r in zip(got, ref):
        _close(_np(g), r, 1e-9, "value")
    _close(_np(flat.grad), ravel_pytree(grads[0])[0], 1e-9, "grad params")
    for x, g in zip(xs, grads[1:]):
        _close(_np(x.grad), g, 1e-9, "grad input")
    factory = tmodels.td3_models if kind == "q" else tmodels.ppo_models
    _, critic = factory(tcfg, agent_id, device="cpu", dtype=torch.float64)
    critic.load_state_dict(KINDS[kind][2](_np_tree(params), tcfg, agent_id))
    with torch.no_grad():
        out = critic(*map(_t, inputs))
    for g, r in zip(out if kind == "q" else (out,), ref):
        _close(_np(g), r, 1e-12, "structured")


def test_ctde_update_draws_shapes():
    """Under CTDE each agent's TD3 draws carry a target-smoothing noise per
    agent, and its SAC draws a next-obs and an actor-loss sample per agent."""
    _, tcfg = _cfgs(**CTDE)
    agents = [ttd3.TD3Agent(tcfg, i, "cpu") for i in AGENTS]
    args = (16, 5, tcfg.obs_dim_n, tcfg.action_dim_n,
            [a.critic_widths for a in agents],
            [a.actor_widths for a in agents],
            torch.Generator().manual_seed(0), "cpu")
    for d in D.make_update_draws(*args, ctde=True).agents:
        assert [t.shape for t in d.target_noise] == [(16, 4), (16, 1)]
    for d, a in zip(D.make_sac_update_draws(*args, ctde=True).agents, agents):
        for joint in (d.next_joint, d.pi_joint):
            assert [t.shape for t in joint] == [(16, 4), (16, 1)]
        assert d.n_pi.shape == d.next_noise.shape == (16, a.action_dim)
    assert D.make_sac_update_draws(*args).agents[0].next_joint is None


# ---------------------------------------------------------------------------
# One update
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_matd3_train_step_matches_jax(family, gate):
    """One MATD3 ``train_step`` for both agents from the same states, batch
    and draws as JAX, with the delayed actor step not taken and taken:
    losses, parameters, targets, ``mu``/``nu`` and the counts within 1e-9,
    float64 (``test_torch_td3.py``'s check)."""
    train_step_vs_jax(gate, **CTDE, **FAMILIES[family])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_ppo_ctde_train_step_matches_jax(family):
    """One CTDE PPO ``train_step`` (the V critic over both agents' obs in
    the GAE pass and its minibatches) within 1e-9, float64
    (``test_torch_ppo.py``'s check)."""
    ppo_train_step_vs_jax(**CTDE, **FAMILIES[family])


# ---------------------------------------------------------------------------
# The training entry point
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("algo", ["TD3", "SAC", "PPO"])
def test_ctde_train_loop_cpu(algo, family):
    """``train`` under CTDE on the CPU at a tiny size: both agents update
    on every train superstep with finite losses, and the critics are built
    over the joint widths."""
    from gym_rotor_tpu_torch.train import train
    if algo == "PPO":
        cfg = TConfig(**PPO, max_steps=4, critic_hidden_dim=8,
                      actor_hidden_dim=(8, 4), **CTDE, **FAMILIES[family])
        n, want = 3, 3
    else:
        cfg = TConfig(num_envs=6, max_steps=4, start_timesteps=12,
                      batch_size=8, replay_buffer_size=40, critic_hidden_dim=8,
                      actor_hidden_dim=(8, 4), rl_algo=algo, **CTDE,
                      **FAMILIES[family])
        n, want = 6, 4
    losses = []
    run = train(cfg, n, device="cpu", log=None,
                on_superstep=lambda i, warm, m, r: losses.extend(
                    float(v) for k, v in m.items() if "loss" in k))
    assert [s.total_it for s in run["states"]] == [want, want]
    assert losses and all(np.isfinite(losses))
    for agent in run["agents"]:
        assert agent.is_ctde
        first = next(iter(agent.critic_net.parameters()))
        assert sum(cfg.obs_dim_n) in first.shape or \
            sum(cfg.obs_dim_n) + sum(cfg.action_dim_n) in first.shape
