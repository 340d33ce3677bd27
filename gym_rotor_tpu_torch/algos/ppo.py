"""PPO learner (port of ``gym_rotor_tpu/algos/ppo.py``).

One full update per horizon: GAE(lambda) advantages and TD targets from the
V critic, then ``K_epochs`` of shuffled equal-size minibatches (``T // mb``
per epoch, as JAX, which drops the remainder), each an actor step on the
clipped surrogate with its decaying entropy bonus, CAPS and (EMLP
networks) the spectral-norm penalty, and a critic step on the
L2-regularised TD error with its spectral penalty: ``_train_one`` line for
line, DTDE and CTDE.  Under CTDE the V critic reads every agent's obs and
next obs (``ppo.py:170-176``), in the GAE pass and in its minibatches; the
actor and the advantages stay the agent's own.

On the card the update runs through the port's kernels: GAE is K12
(``kernels/gae.py``), the surrogate K13 (``kernels/ppo_loss.py``, forward
and backward), every EMLP block of every forward and backward K3/K4
(``kernels/emlp_block.py``), the power iterations K7 and each minibatch
step one K6 call (no Polyak: PPO keeps no targets); the fold (K5), the
tanh, clips, CAPS, L2 and mse are torch ops.  Acting is one K11 launch per
agent and tick (``kernels/emlp_actor.py``), which writes the log-prob
straight into the horizon.  MLP networks are ``F.linear`` chains; the MLP
actor's acting draw is one launch of its fused forward with K11's head
(``kernels/mlp_ppo_actor.py``), and its loss goes through K13 as the EMLP
actor's.

The horizon (``HorizonBuffer``) is a K2 ring of exactly ``T * B`` rows,
written each tick by ``replay.insert_tick`` with the K8 episode statistics
in the same launch, and the log-prob rows K11 writes; ``horizon()``
gathers each field contiguous once per superstep, in the t-major flattened
order the permutation indexes.  The minibatches are slices of the fields
gathered once per epoch in permutation order (``x[perm]``), the same rows
as JAX's ``x[perm[k mb:(k + 1) mb]]``.  The V critic evaluates the
horizon's observations and next observations in one forward of ``2 T B``
rows (JAX: two forwards, chunked over time; the same rows).

Divergences, deliberate: the state is updated in place, as in
``algos/td3.py``, and ``total_it`` and the optimizer counts are host
integers.  ``entropy_coef`` is a 0-d float32 tensor on the device, as
JAX's, which K13 reads where it lies.  JAX under x64 draws the acting noise
without a dtype (``ppo.py:113``) and so acts, and stores actions and
log-probs, in float64; the port stays in float32 (ROADMAP Queue 3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..envs import draws as D
from ..kernels import gae as K12
from ..kernels.emlp_block import emlp_apply
from ..kernels.ppo_loss import ppo_surrogate
from ..models import mlp
from ..models.zoo import ppo_models
from ..parallel.mesh import pmean
from ..utils.config import Config
from . import regularizers
from . import replay as replay_lib
from .common import FlatAgent, OptState, mse, spectral_penalty


@dataclass
class PPOState:
    actor: torch.Tensor             # flat parameter vectors (ravel order)
    critic: torch.Tensor
    actor_opt: OptState
    critic_opt: OptState
    entropy_coef: torch.Tensor      # 0-d float32
    total_it: int


class Horizon(NamedTuple):
    """One on-policy segment per agent, each field ``(T, B, d)`` (or
    ``(T, d)``): ``rwd`` and ``done`` ``(.., 1)``, ``done`` as 0/1 floats,
    ``next_obs`` the terminal observations (``ppo.py:41-49``)."""
    obs: Tuple[torch.Tensor, ...]
    act: Tuple[torch.Tensor, ...]
    rwd: Tuple[torch.Tensor, ...]
    next_obs: Tuple[torch.Tensor, ...]
    done: Tuple[torch.Tensor, ...]
    logprob: Tuple[torch.Tensor, ...]


class HorizonBuffer:
    """The superstep's segment of ``T`` ticks of ``B`` envs: a ring of
    exactly ``T * B`` rows (``algos/replay.py``'s layout, written by K2
    with K8's statistics) and the ``(T * B, sum act dims)`` log-prob rows
    K11 writes; ``num_envs`` the rank's envs under a process group (default
    ``cfg.num_envs``).  Entry point: on the card unless ``device="cpu"``."""

    def __init__(self, cfg: Config, rollout_len: int, device=None,
                 dtype=torch.float32, num_envs: Optional[int] = None):
        self.T = int(rollout_len)
        self.B = int(cfg.num_envs if num_envs is None else num_envs)
        self.act_dims = tuple(cfg.action_dim_n)
        self.ring = replay_lib.create(self.T * self.B, cfg.obs_dim_n,
                                      self.act_dims, dtype, device)
        self.logp = torch.zeros(self.T * self.B, sum(self.act_dims),
                                dtype=dtype, device=self.ring.data.device)

    def horizon(self) -> Horizon:
        """Every field per agent, contiguous, ``(T, B, d)``."""
        T, B, r = self.T, self.B, self.ring

        def c(fields):
            return tuple(x.contiguous().view(T, B, -1) for x in fields)
        logp = torch.split(self.logp, list(self.act_dims), dim=-1)
        return Horizon(c(r.obs), c(r.act), c(r.rwd), c(r.next_obs),
                       c(r.done), c(logp))


class PPOAgent(FlatAgent):
    """An ``EMLPActorPPO`` or ``ActorPPO`` bound to the state's actor
    vector for acting and an ``EMLPVCritic`` or ``VCritic`` for the
    critic's structure."""

    def __init__(self, cfg: Config, agent_id: int, device=None,
                 dtype=torch.float32):
        def models(generator):
            return ppo_models(cfg, agent_id, device="cpu", dtype=dtype,
                              generator=generator)
        super().__init__(cfg, agent_id, device, dtype, models)

    # -- state
    def init(self, generator: Optional[torch.Generator] = None) -> PPOState:
        """Fresh seeded networks (``log_std`` 0), zero optimizer states and
        ``entropy_coef`` at ``cfg.entropy_coef``."""
        return self.make_state(*self.fresh_flat(generator))

    def make_state(self, actor: torch.Tensor, critic: torch.Tensor,
                   actor_opt: Optional[OptState] = None,
                   critic_opt: Optional[OptState] = None,
                   entropy_coef: Optional[torch.Tensor] = None,
                   total_it: int = 0) -> PPOState:
        actor, critic = self.own(actor), self.own(critic)
        state = PPOState(
            actor=actor, critic=critic,
            actor_opt=actor_opt or self.actor_tx.init(actor),
            critic_opt=critic_opt or self.critic_tx.init(critic),
            entropy_coef=self.own(entropy_coef,
                                  torch.tensor(self.cfg.entropy_coef),
                                  torch.float32),
            total_it=int(total_it))
        self.bind(state)
        return state

    # -- acting
    def choose_action(self, state: PPOState, obs,
                      noise: Optional[torch.Tensor] = None,
                      out: Optional[torch.Tensor] = None,
                      logp: Optional[torch.Tensor] = None):
        """``(action, per-dim log-prob)``: ``clip(mean + exp(log_std)
        noise)`` and the log-density of the clipped action with the N(0,
        1) draw ``noise``, or ``(clip(mean), zeros)`` without it
        (ppo.py:102-116); on the card one K11 launch (EMLP, folded once
        per parameter version) or one launch of the MLP actor's fused
        forward with K11's head, written into ``out`` and ``logp`` when
        given."""
        actor = self.bound_actor(state)
        with torch.no_grad():
            return actor(obs, noise, out, logp)

    # -- the training path's networks, on views of a flat vector
    def actor_mean(self, views: Dict[str, torch.Tensor], obs):
        """``tanh(network(obs))`` through K3/K4, or the MLP actor's tanh
        mean head."""
        if not self.equivariant:
            return torch.tanh(mlp.actor_ppo_pre(views, obs))
        return torch.tanh(emlp_apply(self.actor_net.network, views,
                                     "network.", obs))

    def dist_f(self, views: Dict[str, torch.Tensor], obs):
        """``(mean, log_std)``, ``log_std`` broadcast to ``mean``'s shape."""
        mean = self.actor_mean(views, obs)
        return mean, views["log_std"].expand_as(mean)

    def critic_apply(self, views: Dict[str, torch.Tensor], obs):
        """``V(obs)`` through K3/K4 (the single V network, no twin), or the
        MLP ``VCritic``."""
        if not self.equivariant:
            return mlp.v_critic(views, obs)
        return emlp_apply(self.critic_net.network, views, "network.", obs)


def gae(cfg: Config, values, next_values, rewards, dones, mesh=None):
    """Generalized Advantage Estimation (ppo.py:119-146) through K12:
    ``(normalised advantages, td targets)`` of the inputs' ``(T, B, 1)``
    shape.  Over a sharded ``mesh`` (JAX's ``axis_name``) the mean and the
    variance are averaged over the ranks and the std is Bessel-corrected
    over every rank's entries (``ppo.py:136-145``): K12's sharded route,
    two all-reduces between its launches; at world 1 the one launch."""
    if mesh is not None and mesh.sharded:
        return K12.gae_sharded(values, next_values, rewards, dones,
                               cfg.discount, cfg.GAE_lambda, mesh)
    return K12.gae(values, next_values, rewards, dones, cfg.discount,
                   cfg.GAE_lambda)


def train_step(cfg: Config, agents: Sequence[PPOAgent],
               states: List[PPOState], data: Horizon,
               draws: Sequence[Sequence[D.PPOEpochDraws]], mesh=None):
    """One full PPO update for every agent (ppo.py:149-162), in place;
    ``draws[i]`` holds agent ``i``'s ``K_epochs`` epoch draws.  Returns
    ``(states, metrics)``: the last minibatch's losses of the last epoch,
    0-d tensors on the device (this rank's, unreduced).  ``mesh``: GAE
    normalises over every rank's horizon and each minibatch's flat
    gradient is averaged over the ranks; the minibatches stay
    ``actor_batch_size`` / ``critic_batch_size`` rows of the rank's own
    horizon, so their number shrinks with the world (``ppo.py:220-223``)."""
    metrics = {}
    for i in range(len(agents)):
        m = _train_one(cfg, agents, states, i, data, draws[i], mesh)
        metrics.update({f"agent{i}/{k}": v for k, v in m.items()})
    return states, metrics


def _kernels(views: Dict[str, torch.Tensor]):
    """Every ``kernel`` leaf of a network's views, in flax's tree order (the
    reference's 'weight' parameters, ppo.py:329-343)."""
    return [views[n] for n in sorted(views, key=lambda n: tuple(n.split(".")))
            if n.split(".")[-1] == "kernel"]


def _train_one(cfg: Config, agents, states, i: int, data: Horizon,
               draws: Sequence[D.PPOEpochDraws], mesh=None):
    agent, st = agents[i], states[i]
    m = cfg.max_action

    def flat(x):
        return x.reshape(-1, x.shape[-1])

    # ----- values before any step (ppo.py:170-206): one forward over the
    # observations and the next observations (under CTDE every agent's)
    if agent.is_ctde:
        v_obs = torch.cat(data.obs, dim=-1)
        v_next = torch.cat(data.next_obs, dim=-1)
    else:
        v_obs, v_next = data.obs[i], data.next_obs[i]
    with torch.no_grad():
        both = agent.critic_apply(agent.critic_layout.views(st.critic),
                                  torch.cat([flat(v_obs), flat(v_next)]))
        values, next_values = both.view((2,) + tuple(v_obs.shape[:-1]) + (1,))
        advs, td_targets = gae(cfg, values, next_values, data.rwd[i],
                               data.done[i], mesh)

    st.entropy_coef = st.entropy_coef * cfg.entropy_coef_decay  # ppo.py:208

    obs_i, act_i, lp_old_i = flat(data.obs[i]), flat(data.act[i]), \
        flat(data.logprob[i])
    next_obs_i, advs, td_targets = flat(data.next_obs[i]), flat(advs), \
        flat(td_targets)
    v_obs_i = flat(v_obs)
    T = obs_i.shape[0]
    n_mb_a = max(T // cfg.actor_batch_size, 1)
    n_mb_c = max(T // cfg.critic_batch_size, 1)
    mb_a = min(cfg.actor_batch_size, T)
    mb_c = min(cfg.critic_batch_size, T)

    for d in draws:
        perm = d.perm
        eps = regularizers.caps_noise(d.caps_eps)
        o_p, no_p, a_p, lp_p, ad_p = (x.index_select(0, perm) for x in (
            obs_i, next_obs_i, act_i, lp_old_i, advs))

        # ----- actor minibatches (ppo.py:231-277): one actor forward over
        # [o; o_next; o + eps] serves the surrogate and CAPS
        for k in range(n_mb_a):
            sl = slice(k * mb_a, (k + 1) * mb_a)
            o = o_p[sl]
            leaf = st.actor.detach().requires_grad_(True)
            av = agent.actor_layout.views(leaf)
            mean3 = agent.actor_mean(av, torch.cat([o, no_p[sl], o + eps]))
            mb = o.shape[0]
            aloss = ppo_surrogate(mean3[:mb], av["log_std"], a_p[sl],
                                  lp_p[sl], ad_p[sl], st.entropy_coef,
                                  cfg.clip_rate)
            if agent.equivariant:
                aloss = aloss + 1e-5 * spectral_penalty(av, d.actor_starts)
            m3c = torch.clamp(mean3, -m, m)
            aloss = aloss + regularizers.caps_terms(
                cfg, agent.agent_id, m3c[:mb], m3c[mb:2 * mb], m3c[2 * mb:])
            (agrad,) = torch.autograd.grad(aloss, leaf)
            pmean(agrad, mesh)  # ppo.py:271
            st.actor_opt = agent.actor_tx.update(st.actor, agrad,
                                                 st.actor_opt,
                                                 owner=agent.actor_net)

        # ----- critic minibatches (ppo.py:280-310)
        vo_p, tt_p = v_obs_i.index_select(0, perm), td_targets.index_select(
            0, perm)
        for k in range(n_mb_c):
            sl = slice(k * mb_c, (k + 1) * mb_c)
            leaf = st.critic.detach().requires_grad_(True)
            cv = agent.critic_layout.views(leaf)
            closs = mse(agent.critic_apply(cv, vo_p[sl]), tt_p[sl])
            closs = closs + cfg.l2_reg * sum(torch.sum(w ** 2)
                                             for w in _kernels(cv))
            if agent.equivariant:
                closs = closs + 1e-10 * spectral_penalty(cv, d.critic_starts)
            (cgrad,) = torch.autograd.grad(closs, leaf)
            pmean(cgrad, mesh)  # ppo.py:303
            st.critic_opt = agent.critic_tx.update(st.critic, cgrad,
                                                   st.critic_opt,
                                                   owner=agent.critic_net)
    st.total_it += 1
    return {"actor_loss": aloss.detach(), "critic_loss": closs.detach()}
