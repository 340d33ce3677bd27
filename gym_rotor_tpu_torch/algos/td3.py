"""TD3 and MATD3 learner (port of ``gym_rotor_tpu/algos/td3.py``).

Twin critics with clipped double-Q, target policy smoothing, the delayed
actor update every ``policy_update_freq`` updates, Polyak targets, the flat
AdamW chain with global-norm clipping and cosine warm restarts, CAPS and
the spectral-norm penalty: ``_train_one`` line for line, DTDE and CTDE.
Under CTDE (MATD3, ``td3.py:209-224``, ``:298-306``) each agent's critic
sees every agent's obs and action: its target is every agent's target actor
on its own ``next_obs`` with its own clipped smoothing noise, and its actor
loss puts the agent's action beside the other agents' *current* actions.
Agents update in order, in place, so agent 1 reads agent 0's updated
actor and targets, as JAX's ``train_step`` passes ``new_states`` on.

The networks come from ``models/zoo.py::td3_models``: EMLP (``use_equiv``)
or plain MLPs.  On the card the update runs through the port's kernels:
the sample writes the update's operands (K2 sample, ``algos/replay.py``:
the critic input ``[obs | act]``, the CTDE joint fields and the actor
loss's stack ``[obs; next_obs; obs + eps]``, its last block written here),
every EMLP block of every forward and backward is K3/K4
(``kernels/emlp_block.py``, under autograd), the power iterations are K7,
each network's optimizer step (and its Polyak) is one K6 call; the fold
(K5), heads, tanh, clips and losses are torch ops.  MLP networks are
``F.linear`` chains (cuBLAS, as JAX leaves them to XLA's dots) and carry no
spectral penalty (``td3.py:256``, ``:311``); their actor loss applies ``q1``
alone through ``critic_twin_split`` (``td3.py:275-279``), as the EMLP actor
loss applies ``network1``.  With ``equiv_fold=False`` (the default) JAX
projects each EMLP layer's raw kernel on every forward; here each loss
projects once and fans the projected weights out to its forwards, the same
function up to the summation order of the gradient (float64: within 1e-9
relative of JAX, ``tests/test_torch_td3.py``, ``tests/test_torch_mlp.py``).

Divergences, deliberate: the state is updated in place (parameters, targets
and optimizer moments are flat tensors K6 writes), and ``total_it`` and the
optimizer counts are host integers, the mirror of the JAX device counters,
so the delayed gate costs no device sync.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from ..envs.draws import AgentDraws
from ..kernels.emlp_block import emlp_apply
from ..models import mlp
from ..models.zoo import td3_models
from ..parallel.mesh import pmean
from ..utils.config import Config
from . import regularizers
from .common import FlatAgent, OptState, mse, spectral_penalty
from .replay import Batch, learner_operands

# the actor loss's rows, as a sample lays them out: [obs; next_obs; obs +
# eps] (td3.py:284)
CAPS_STACK = ("obs", "next_obs", "eps")


@dataclass
class TD3State:
    actor: torch.Tensor             # flat parameter vectors (ravel order)
    critic: torch.Tensor
    actor_target: torch.Tensor
    critic_target: torch.Tensor
    actor_opt: OptState
    critic_opt: OptState
    total_it: int


class TD3Agent(FlatAgent):
    """The actor (``EMLPActorDet`` or ``ActorTD3``) bound to the state's
    actor vector for acting, and the twin critic (``EMLPCriticTwin`` or
    ``CriticTwin``) for the critic's structure."""

    def __init__(self, cfg: Config, agent_id: int, device=None,
                 dtype=torch.float32):
        def models(generator):
            return td3_models(cfg, agent_id, device="cpu", dtype=dtype,
                              generator=generator)
        super().__init__(cfg, agent_id, device, dtype, models)

    # -- state
    def init(self, generator: Optional[torch.Generator] = None) -> TD3State:
        """Fresh seeded networks, targets equal to them, zero optimizer
        state."""
        return self.make_state(*self.fresh_flat(generator))

    def make_state(self, actor: torch.Tensor, critic: torch.Tensor,
                   actor_target=None, critic_target=None,
                   actor_opt: Optional[OptState] = None,
                   critic_opt: Optional[OptState] = None,
                   total_it: int = 0) -> TD3State:
        actor, critic = self.own(actor), self.own(critic)
        state = TD3State(
            actor=actor, critic=critic,
            actor_target=self.own(actor_target, actor),
            critic_target=self.own(critic_target, critic),
            actor_opt=actor_opt or self.actor_tx.init(actor),
            critic_opt=critic_opt or self.critic_tx.init(critic),
            total_it=int(total_it))
        self.bind(state)
        return state

    # -- acting
    def act(self, state: TD3State, obs, out: Optional[torch.Tensor] = None):
        """Deterministic action; for EMLP on the card one K3 launch (the
        acting kernel, folded once per parameter version), for an MLP three
        ``F.linear`` on the bound parameters."""
        actor = self.bound_actor(state)
        with torch.no_grad():
            return actor(obs, out)

    def choose_action(self, state: TD3State, obs, noise_std: float,
                      noise: torch.Tensor):
        """Policy + exploration noise (td3.py:143-147); ``noise`` is the
        N(0, 1) draw."""
        a = self.act(state, obs)
        return torch.clamp(a + noise_std * noise, -self.cfg.max_action,
                           self.cfg.max_action)

    # -- the training path's networks, on views of a flat vector
    def actor_apply(self, views: Dict[str, torch.Tensor], obs):
        if not self.equivariant:
            return mlp.actor_td3(views, obs)
        return torch.tanh(emlp_apply(self.actor_net.network, views,
                                     "network.", obs))

    def critic_q1(self, views: Dict[str, torch.Tensor], obs, act):
        if not self.equivariant:
            return mlp.q_net(mlp.critic_twin_split(views)[0], "", obs, act)
        x = torch.cat([obs, act], dim=-1)
        return emlp_apply(self.critic_net.network1, views, "network1.", x)


def train_step(cfg: Config, agents: Sequence[TD3Agent],
               states: List[TD3State], batch: Batch,
               draws: Sequence[AgentDraws], mesh=None):
    """One TD3 update for every agent (td3.py:165-192), in place.  Returns
    ``(states, metrics)``; the metrics are 0-d tensors on the device (this
    rank's, unreduced).  ``mesh`` (``parallel/mesh.py``, JAX's
    ``axis_name``): each flat gradient is averaged over its ranks before
    the optimizer, so the replicated parameters stay equal."""
    metrics = {}
    for i in range(len(agents)):
        m = _train_one(cfg, agents, states, i, batch, draws[i], mesh)
        metrics.update({f"agent{i}/{k}": v for k, v in m.items()})
    return states, metrics


def _smoothed(cfg: Config, agent: TD3Agent, actor_target: torch.Tensor,
              next_obs, noise):
    """The target actor's action with clipped smoothing noise, clipped to
    ``max_action`` (td3.py:209-233)."""
    a_next = agent.actor_apply(agent.actor_layout.views(actor_target),
                               next_obs)
    noise = torch.clamp(cfg.target_noise * noise, -cfg.noise_clip,
                        cfg.noise_clip)
    return torch.clamp(a_next + noise, -cfg.max_action, cfg.max_action)


def _train_one(cfg: Config, agents, states, i: int, batch: Batch,
               d: AgentDraws, mesh=None):
    agent, st = agents[i], states[i]
    obs, rwd = batch.obs[i], batch.rwd[i]
    next_obs, done = batch.next_obs[i], batch.done[i]
    m = cfg.max_action
    gate = (st.total_it + 1) % cfg.policy_update_freq == 0

    # the sampled operands: the critic input [obs | act] (CTDE: the joint
    # obs and actions), the CTDE joint next_obs and, on a gated update, the
    # actor loss's stack; its last block, obs + eps, written before any
    # autograd records a view of the sample's buffer
    sa, t_obs, stack = learner_operands(batch, i, agent.is_ctde,
                                        CAPS_STACK if gate else None)
    B = obs.shape[0]
    if gate:
        torch.add(obs, regularizers.caps_noise(d.caps_eps),
                  out=stack[2 * B:])

    # ----- target-policy smoothing and the target Q (td3.py:205-254):
    # under CTDE every agent's target actor on its own next_obs
    with torch.no_grad():
        if agent.is_ctde:
            t_act = torch.cat([
                _smoothed(cfg, other, states[j].actor_target,
                          batch.next_obs[j], d.target_noise[j])
                for j, other in enumerate(agents)], dim=-1)
        else:
            t_obs = next_obs
            t_act = _smoothed(cfg, agent, st.actor_target, next_obs,
                              d.target_noise)
        tq1, tq2 = agent.critic_apply(
            agent.critic_layout.views(st.critic_target), t_obs, t_act)
        target_q = rwd + cfg.discount * (1.0 - done) * torch.minimum(tq1, tq2)

    # ----- critic update (td3.py:240-266)
    leaf = st.critic.detach().requires_grad_(True)
    cv = agent.critic_layout.views(leaf)
    q1, q2 = agent.critic_apply_sa(cv, sa)
    closs = mse(q1, target_q) + mse(q2, target_q)
    if agent.equivariant:
        closs = closs + 1e-8 * spectral_penalty(cv, d.critic_starts)
    (cgrad,) = torch.autograd.grad(closs, leaf)
    pmean(cgrad, mesh)  # td3.py:263
    # the critic target's Polyak runs in the delayed branch on the updated
    # critic (td3.py:325): the same values when done in this K6 call
    st.critic_opt = agent.critic_tx.update(
        st.critic, cgrad, st.critic_opt,
        target=st.critic_target if gate else None, tau=cfg.tau,
        owner=agent.critic_net)
    st.total_it += 1

    # ----- delayed actor + target update (td3.py:271-342)
    if gate:
        critic = agent.critic_layout.views(st.critic.detach())
        leaf = st.actor.detach().requires_grad_(True)
        av = agent.actor_layout.views(leaf)
        a3 = torch.clamp(agent.actor_apply(av, stack), -m, m)
        a_cur, a_nxt, a_prt = torch.split(a3, B, dim=0)
        if agent.is_ctde:
            # the other agents' current actors, constants here (td3.py:298)
            with torch.no_grad():
                others = [None if j == i else torch.clamp(other.actor_apply(
                    other.actor_layout.views(states[j].actor), batch.obs[j]),
                    -m, m) for j, other in enumerate(agents)]
            others[i] = a_cur
            n_obs = sum(a.obs_dim for a in agents)
            aloss = -agent.critic_q1(critic, sa[:, :n_obs],
                                     torch.cat(others, dim=-1)).mean()
        else:
            aloss = -agent.critic_q1(critic, obs, a_cur).mean()
        if agent.equivariant:
            aloss = aloss + 1e-5 * spectral_penalty(av, d.actor_starts)
        aloss = aloss + regularizers.caps_terms(cfg, agent.agent_id, a_cur,
                                                a_nxt, a_prt)
        (agrad,) = torch.autograd.grad(aloss, leaf)
        pmean(agrad, mesh)  # td3.py:321
        st.actor_opt = agent.actor_tx.update(
            st.actor, agrad, st.actor_opt, target=st.actor_target,
            tau=cfg.tau, owner=agent.actor_net)
        aloss = aloss.detach()
    else:
        aloss = torch.zeros((), dtype=closs.dtype, device=closs.device)
    return {"critic_loss": closs.detach(), "actor_loss": aloss}
