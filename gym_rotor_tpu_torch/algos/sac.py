"""Soft Actor-Critic learner (port of ``gym_rotor_tpu/algos/sac.py``).

Squashed-Gaussian actor, twin critics with the entropy term in the target,
a fixed (``sac_alpha``) or auto-tuned temperature, the critic target's
Polyak every ``policy_update_freq`` updates, CAPS and (EMLP networks) the
spectral-norm penalty: ``_train_one`` line for line, DTDE and CTDE.  The
actor is updated on every update.  Under CTDE (``sac.py:153-171``,
``:212-220``) the critic sees every agent's obs and action: its target
action is every agent's current actor sampled on its own ``next_obs``, and
the actor loss's joint action puts the agent's sample beside the other
agents' current samples, with the log-prob and the three CAPS samples from
their own draws.  Agents update in order, in place, as in ``algos/td3.py``.

On the card the update runs through the port's kernels: the sample
writes the update's operands (K2 sample, ``algos/replay.py``: the critic
input ``[obs | act]``, the CTDE joint fields and the actor loss's stack
``[obs; obs; next_obs; obs + eps]``, its last block written here), every
EMLP block of every forward and backward is K3/K4
(``kernels/emlp_block.py``), SAC's heads with the squashed sample and its
log-prob are one launch of the fused head (K10, ``kernels/sac_sample.py``,
on the trunk's output and the heads' weights: the EMLP mean head's K5-folded
``W_eff``, the MLP's Dense kernels; forward for the target samples and the
actor loss, one backward launch for the actor loss), the
power iterations K7 and each network's optimizer step one K6 call; the
fold (K5), tanh clips and losses are torch ops, and so is the
temperature's AdamW on its one scalar.  MLP networks' trunks are
``F.linear`` chains, their heads the same fused kernel.  Acting is one
launch per agent: K9 for an EMLP agent (``kernels/emlp_actor.py``), the
fused MLP SAC actor (``kernels/mlp_sac_actor.py``) for an MLP one.
Samples of one actor on one set of weights are fused along the batch (one
forward over the rows with their draws), as JAX fuses the DTDE actor
loss's four.

Divergences, deliberate: the state is updated in place, as in
``algos/td3.py``, and ``total_it`` and the optimizer counts are host
integers.  ``log_alpha`` is a 0-d float32 tensor whatever the parameters'
dtype, as in JAX (``sac.py:81``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from ..envs import draws as D
from ..kernels.emlp_block import emlp_trunk, fold_linear
from ..kernels.sac_sample import sac_head_sample
from ..models import mlp
from ..models.zoo import sac_models
from ..ops.so3 import sqrt_rn
from ..parallel.mesh import pmean
from ..utils.config import Config
from . import regularizers
from .common import FlatAgent, OptState, mse, spectral_penalty
from .replay import Batch, learner_operands


def caps_stack(ctde: bool):
    """The actor loss's rows, as a sample lays them out: ``[obs; obs;
    next_obs; obs + eps]`` (under CTDE ``obs`` once more first, the joint
    action's sample)."""
    return ("obs",) * (3 if ctde else 2) + ("next_obs", "eps")


@dataclass
class AlphaOptState:
    """``optax.adamw``'s state on the scalar ``log_alpha``: the
    ``ScaleByAdamState`` (``count`` a host integer, ``mu``, ``nu`` 0-d)."""
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


@dataclass
class SACState:
    actor: torch.Tensor             # flat parameter vectors (ravel order)
    critic: torch.Tensor
    critic_target: torch.Tensor
    actor_opt: OptState
    critic_opt: OptState
    log_alpha: torch.Tensor         # 0-d float32
    alpha_opt: AlphaOptState
    total_it: int


class ScalarAdamW:
    """``optax.adamw(lr)`` on one scalar (b1 0.9, b2 0.999, eps 1e-8, weight
    decay 1e-4, no clip, a constant rate) as torch scalar ops in optax's
    order; the bias corrections in double, rounded to the scalar's dtype
    where used (optax's ``astype``)."""
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, 1e-4

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, p: torch.Tensor) -> AlphaOptState:
        return AlphaOptState(0, torch.zeros_like(p), torch.zeros_like(p))

    def update(self, p: torch.Tensor, g: torch.Tensor, state: AlphaOptState):
        """Returns ``(new p, new state)``."""
        g = g.to(p.dtype)
        mu = (1 - self.b1) * g + self.b1 * state.mu
        nu = (1 - self.b2) * (g * g) + self.b2 * state.nu
        c = state.count + 1
        u = (mu / (1 - self.b1 ** c)) / (sqrt_rn(nu / (1 - self.b2 ** c))
                                         + self.eps)
        u = u + self.wd * p
        return p + (-self.lr) * u, AlphaOptState(c, mu, nu)


class SACAgent(FlatAgent):
    """An ``EMLPActorSAC`` or ``ActorSAC`` bound to the state's actor
    vector for acting, an ``EMLPCriticTwin`` or ``CriticTwin`` for the
    critic's structure, and the temperature's optimizer."""

    def __init__(self, cfg: Config, agent_id: int, device=None,
                 dtype=torch.float32):
        def models(generator):
            return sac_models(cfg, agent_id, device="cpu", dtype=dtype,
                              generator=generator)
        super().__init__(cfg, agent_id, device, dtype, models)
        self.alpha_tx = ScalarAdamW(cfg.lr_a[agent_id])
        self.target_entropy = -float(self.action_dim)   # sac.py:54
        self._alpha = torch.tensor(cfg.sac_alpha, dtype=torch.float32,
                                   device=self.device)

    # -- state
    def init(self, generator: Optional[torch.Generator] = None) -> SACState:
        """Fresh seeded networks, the critic target equal to the critic,
        ``log_alpha`` 0 and zero optimizer states."""
        return self.make_state(*self.fresh_flat(generator))

    def make_state(self, actor: torch.Tensor, critic: torch.Tensor,
                   critic_target=None, actor_opt: Optional[OptState] = None,
                   critic_opt: Optional[OptState] = None,
                   log_alpha: Optional[torch.Tensor] = None,
                   alpha_opt: Optional[AlphaOptState] = None,
                   total_it: int = 0) -> SACState:
        actor, critic = self.own(actor), self.own(critic)
        log_alpha = self.own(log_alpha, torch.zeros(()), torch.float32)
        state = SACState(
            actor=actor, critic=critic,
            critic_target=self.own(critic_target, critic),
            actor_opt=actor_opt or self.actor_tx.init(actor),
            critic_opt=critic_opt or self.critic_tx.init(critic),
            log_alpha=log_alpha,
            alpha_opt=alpha_opt or self.alpha_tx.init(log_alpha),
            total_it=int(total_it))
        self.bind(state)
        return state

    def alpha(self, state: SACState) -> torch.Tensor:
        """The temperature, a 0-d float32 tensor (sac.py:119-122)."""
        if self.cfg.automatic_entropy_tuning:
            return torch.exp(state.log_alpha)
        return self._alpha

    # -- acting
    def choose_action(self, state: SACState, obs,
                      noise: Optional[torch.Tensor] = None,
                      out: Optional[torch.Tensor] = None):
        """``tanh(mean + exp(log_std) noise)`` with the N(0, 1) draw
        ``noise``, or the deterministic ``tanh(mean)`` without it
        (sac.py:108-117); on the card one launch: K9 (EMLP, folded once per
        parameter version) or the fused MLP SAC actor."""
        actor = self.bound_actor(state)
        with torch.no_grad():
            return actor(obs, noise, out)

    # -- the training path's networks, on views of a flat vector
    def trunk_f(self, views: Dict[str, torch.Tensor], obs):
        """``(h, heads)``: the trunk's last hidden activations (EMLP blocks
        through K3/K4, or the MLP's ``F.linear`` chain) and the heads
        ``(W_m, b_m, W_ls, b_ls)``: the EMLP mean head folded (K5) to
        ``W_eff`` (act, H), or the MLP's Dense kernels (H, act)."""
        if not self.equivariant:
            return mlp.sac_trunk(views, obs), mlp.sac_heads(views)
        net = self.actor_net
        h = emlp_trunk(net, views, "", obs)
        W, b = fold_linear(net.network_head, views, "network_head.")
        return h, (W, b, views["log_std_linear.kernel"],
                   views["log_std_linear.bias"])

    def sample_f(self, views: Dict[str, torch.Tensor], obs, noise):
        """``(action, log_prob)``: the trunk, then the heads and the sample
        in one launch of the fused head (its torch chain on the CPU)."""
        h, heads = self.trunk_f(views, obs)
        return sac_head_sample(h, *heads, noise, not self.equivariant)


def make_act_fn(agents: Sequence[SACAgent]):
    """The superstep's acting hook (``train.py:352-366``):
    ``act(states, obs, noise_std, noise) -> joint action``, each agent's
    sample (K9, or the fused MLP SAC actor) written into its columns;
    ``noise_std`` is unused."""
    dims = [a.action_dim for a in agents]

    def act(states, obs, noise_std, noise):
        out = torch.empty(obs[0].shape[0], sum(dims), dtype=agents[0].dtype,
                          device=obs[0].device)
        col = 0
        for agent, st, o, n, d in zip(agents, states, obs, noise, dims):
            agent.choose_action(st, o, n, out=out[:, col:col + d])
            col += d
        return out
    return act


def superstep_hooks(agents: Sequence[SACAgent]):
    """The keyword arguments that make ``make_td3_superstep`` run SAC."""
    return dict(train_fn=train_step, act_fn=make_act_fn(agents),
                draws_fn=D.make_sac_update_draws,
                stack=caps_stack(agents[0].is_ctde))


def train_step(cfg: Config, agents: Sequence[SACAgent],
               states: List[SACState], batch: Batch,
               draws: Sequence[D.SACAgentDraws], mesh=None):
    """One SAC update for every agent (sac.py:125-138), in place.  Returns
    ``(states, metrics)``; the metrics are 0-d tensors on the device (this
    rank's, unreduced).  ``mesh``: the critic's and the actor's flat
    gradients are averaged over its ranks (``sac.py:196``, ``:259``); the
    temperature's is not (``sac.py:264-271``), so each rank steps its own
    ``log_alpha`` on its own log-probs, as each JAX device does."""
    metrics = {}
    for i in range(len(agents)):
        m = _train_one(cfg, agents, states, i, batch, draws[i], mesh)
        metrics.update({f"agent{i}/{k}": v for k, v in m.items()})
    return states, metrics


def _train_one(cfg: Config, agents, states, i: int, batch: Batch,
               d: D.SACAgentDraws, mesh=None):
    agent, st = agents[i], states[i]
    obs, rwd = batch.obs[i], batch.rwd[i]
    next_obs, done = batch.next_obs[i], batch.done[i]
    m = cfg.max_action
    alpha = agent.alpha(st)
    gate = (st.total_it + 1) % cfg.policy_update_freq == 0

    B = obs.shape[0]
    # the sampled operands: the critic input [obs | act] (CTDE: the joint
    # obs and actions), the CTDE joint next_obs, the actor loss's stack;
    # its last block, obs + eps, written before any autograd records a
    # view of the sample's buffer
    sa, t_obs, stack = learner_operands(batch, i, agent.is_ctde,
                                        caps_stack(agent.is_ctde))
    torch.add(obs, regularizers.caps_noise(d.caps_eps), out=stack[-B:])

    # ----- target sample from the current actor + entropy (sac.py:152-193)
    with torch.no_grad():
        if agent.is_ctde:
            # every agent's sample on its next_obs; the agent's own and its
            # log-prob sample in one forward of 2 B rows
            a2, lp2 = agent.sample_f(
                agent.actor_layout.views(st.actor),
                torch.cat([next_obs, next_obs]),
                torch.cat([d.next_joint[i], d.next_noise]))
            logp_next = lp2[B:]
            t_act = torch.cat([
                a2[:B] if j == i else other.sample_f(
                    other.actor_layout.views(states[j].actor),
                    batch.next_obs[j], d.next_joint[j])[0]
                for j, other in enumerate(agents)], dim=-1)
        else:
            t_act, logp_next = agent.sample_f(
                agent.actor_layout.views(st.actor), next_obs, d.next_noise)
            t_obs = next_obs
        tq1, tq2 = agent.critic_apply(
            agent.critic_layout.views(st.critic_target), t_obs, t_act)
        target_q = rwd + cfg.discount * (1.0 - done) * (
            torch.minimum(tq1, tq2) - alpha * logp_next)

    # ----- critic update (sac.py:173-199)
    leaf = st.critic.detach().requires_grad_(True)
    cv = agent.critic_layout.views(leaf)
    q1, q2 = agent.critic_apply_sa(cv, sa)
    closs = mse(q1, target_q) + mse(q2, target_q)
    if agent.equivariant:
        closs = closs + 1e-8 * spectral_penalty(cv, d.critic_starts)
    (cgrad,) = torch.autograd.grad(closs, leaf)
    pmean(cgrad, mesh)  # sac.py:196
    # the critic target's Polyak runs after the actor step on the updated
    # critic (sac.py:277-289): the same values when done in this K6 call
    st.critic_opt = agent.critic_tx.update(
        st.critic, cgrad, st.critic_opt,
        target=st.critic_target if gate else None, tau=cfg.tau,
        owner=agent.critic_net)

    # ----- actor update on the updated critic (sac.py:201-261): one actor
    # forward over the stack [obs; obs; next_obs; obs + eps] (under CTDE
    # [obs; obs; obs; next_obs; obs + eps], the joint action's sample first)
    critic = agent.critic_layout.views(st.critic.detach())
    leaf = st.actor.detach().requires_grad_(True)
    av = agent.actor_layout.views(leaf)
    draws = [d.n_pi, d.n_caps, d.n_caps, d.n_caps]
    if agent.is_ctde:
        draws = [d.pi_joint[i]] + draws
    k = len(draws) - 4
    a_r, logp_r = agent.sample_f(av, stack, torch.cat(draws, dim=0))
    ac = torch.clamp(a_r[(k + 1) * B:], -m, m)
    logp = logp_r[k * B:(k + 1) * B]
    if agent.is_ctde:
        # the other agents' current samples, constants here (sac.py:212-220)
        with torch.no_grad():
            others = [None if j == i else other.sample_f(
                other.actor_layout.views(states[j].actor), batch.obs[j],
                d.pi_joint[j])[0] for j, other in enumerate(agents)]
        others[i] = a_r[:B]
        n_obs = sum(a.obs_dim for a in agents)
        q1, q2 = agent.critic_apply(critic, sa[:, :n_obs],
                                    torch.cat(others, dim=-1))
    else:
        q1, q2 = agent.critic_apply(critic, obs, a_r[:B])
    aloss = -(torch.minimum(q1, q2) - alpha * logp).mean()
    if agent.equivariant:
        aloss = aloss + 1e-5 * spectral_penalty(av, d.actor_starts)
    aloss = aloss + regularizers.caps_terms(cfg, agent.agent_id, ac[:B],
                                            ac[B:2 * B], ac[2 * B:])
    (agrad,) = torch.autograd.grad(aloss, leaf)
    pmean(agrad, mesh)  # sac.py:259
    st.actor_opt = agent.actor_tx.update(st.actor, agrad, st.actor_opt,
                                         owner=agent.actor_net)

    # ----- entropy temperature (sac.py:263-274)
    if cfg.automatic_entropy_tuning:
        c = agent.target_entropy + logp.detach()
        tloss = -(st.log_alpha * c).mean()
        tgrad = (c * (-1.0 / c.numel())).sum()
        st.log_alpha, st.alpha_opt = agent.alpha_tx.update(
            st.log_alpha, tgrad, st.alpha_opt)
    else:
        tloss = torch.zeros((), dtype=closs.dtype, device=closs.device)
    st.total_it += 1
    return {"critic_loss": closs.detach(), "actor_loss": aloss.detach(),
            "alpha_loss": tloss, "alpha": agent.alpha(st)}
