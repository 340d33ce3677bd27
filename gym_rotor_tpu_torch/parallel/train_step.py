"""The actor-learner supersteps on one device (port of
``gym_rotor_tpu/parallel/train_step.py``, run on one device).

``make_td3_superstep`` (``:68`` ``make_sharded_td3_superstep``), off-policy:
``rollout_len`` ticks of (act -> K1 tick -> K2 ring write with the K8
episode statistics), then ``n_updates`` of (K2 sample into the learner's
operands -> ``train_fn``).
TD3 by default; JAX's ``train_fn`` and ``act_fn`` hooks and a draws
factory make it run SAC (``algos/sac.py::superstep_hooks``), DTDE or
CTDE, with EMLP or MLP networks.  JAX's
``act_prep`` (fold the actors once per superstep) has no counterpart: each
acting module caches its fold on its ``param_version``, which does the
same.  A ``warm`` superstep acts with uniform actions in [-1, 1) and runs
no update (the reference's ``start_timesteps`` warm-up).  A train
superstep acts through ``act_fn``: by default the current TD3 actors (K3,
folded once per parameter version) plus clipped Gaussian exploration
noise.

``make_ppo_superstep`` (``:229`` ``make_sharded_ppo_superstep``),
on-policy: ``rollout_len`` ticks of (K11 acting draw per agent, its
log-prob written into the horizon -> K1 tick -> K2 write of the horizon's
row with K8's statistics), then one full PPO update (``algos/ppo.py``:
GAE, ``K_epochs`` of minibatches) over the horizon.

Both return the JAX step's metrics: ``mean_reward``, ``fin_sum``,
``fin_cnt`` and, when training, the last update's ``agent{i}/...`` losses
(0-d or 1-d tensors on the device; reading them syncs).

Everything the step carries is updated in place: the ``TickLoop`` (env
state, packed on the card), the replay ring or the horizon, the agents'
states and ``ep_ret``; the step returns the new observations and the
metrics.  Random draws come from ``generator`` or, for parity tests, from
``draws = (ticks, updates)`` (``envs/draws.py``): ``rollout_len``
``TickDraws``, then ``n_updates`` ``UpdateDraws`` (off-policy) or, per
agent, ``K_epochs`` ``PPOEpochDraws`` (PPO).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..algos import ppo as ppo_lib
from ..algos import replay as replay_lib
from ..algos import td3 as td3_lib
from ..envs import draws as D
from ..kernels.env_tick import TickLoop
from ..utils.config import Config
from ..utils.device import resolve_device


def make_td3_superstep(cfg: Config, agents: Sequence, device=None,
                       rollout_len: int = 1, n_updates: int = 1,
                       train_fn: Optional[Callable] = None,
                       act_fn: Optional[Callable] = None,
                       draws_fn: Optional[Callable] = None,
                       stack: Sequence[str] = td3_lib.CAPS_STACK):
    """Returns ``step(loop, obs, rstate, states, ep_ret, noise_std,
    warm=False, generator=None, draws=None) -> (obs, metrics)``.

    ``train_fn(cfg, agents, states, batch, agent_draws) -> (states,
    metrics)`` is the update (default ``td3.train_step``);
    ``act_fn(states, obs, noise_std, policy_draws) -> joint action`` the
    train ticks' policy (default TD3's noisy deterministic actors);
    ``draws_fn`` makes an update's
    ``UpdateDraws`` with ``envs/draws.py::make_update_draws``'s signature
    (default that function; ``ctde`` set for a MODUL CTDE ``cfg``);
    ``stack`` the learner's CAPS stack, which each sample writes with the
    other operands (``algos/replay.py::sample``; default TD3's)."""
    dev = resolve_device(device)
    n = cfg.n_agents
    act_dims = tuple(cfg.action_dim_n)
    m = cfg.max_action
    train_fn = train_fn or td3_lib.train_step
    draws_fn = draws_fn or D.make_update_draws

    def td3_act(states, obs, noise_std, policy):
        B = obs[0].shape[0]
        actions = torch.empty(B, sum(act_dims), dtype=agents[0].dtype,
                              device=dev)
        col = 0
        for agent, st, o, d in zip(agents, states, obs, act_dims):
            agent.act(st, o, out=actions[:, col:col + d])
            col += d
        noise = torch.cat(list(policy), dim=-1)
        return torch.clamp(actions + noise_std * noise, -m, m)

    act_fn = act_fn or td3_act

    def step(loop: TickLoop, obs: tuple, rstate: replay_lib.ReplayState,
             states: List, ep_ret: torch.Tensor,
             noise_std: float, warm: bool = False,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Tuple[Sequence[D.TickDraws],
                                   Sequence[D.UpdateDraws]]] = None):
        # the JAX step takes noise_std as a float32 array
        noise_std = float(np.float32(noise_std))
        stats = torch.zeros(n + 2, dtype=torch.float32, device=dev)
        for t in range(rollout_len):
            td = (draws[0][t] if draws is not None else
                  D.make_tick_draws(loop.B, act_dims, warm, generator, dev,
                                    loop.dtype))
            actions = (D.uniform_in(td.policy, -1.0, 1.0) if warm else
                       act_fn(states, obs, noise_std, td.policy))
            out = loop.step(actions, td.env)
            replay_lib.insert_tick(rstate, obs, actions, out.reward,
                                   out.info["terminal_obs"], out.done,
                                   reset=out.reset_happened, ep_ret=ep_ret,
                                   stats=stats)
            obs = out.obs
        metrics = {"mean_reward": stats[n + 1] / (rollout_len * loop.B * n),
                   "fin_sum": stats[:n], "fin_cnt": stats[n]}
        if warm:
            return obs, metrics
        for u in range(n_updates):
            ud = (draws[1][u] if draws is not None else
                  draws_fn(cfg.batch_size, rstate.filled, cfg.obs_dim_n,
                           act_dims, [a.critic_widths for a in agents],
                           [a.actor_widths for a in agents], generator, dev,
                           agents[0].dtype, ctde=cfg.is_ctde))
            batch = replay_lib.sample(rstate, cfg.batch_size, idx=ud.idx,
                                      ctde=cfg.is_ctde, stack=tuple(stack))
            states, um = train_fn(cfg, agents, states, batch, ud.agents)
        metrics.update(um)
        return obs, metrics

    return step


def make_ppo_superstep(cfg: Config, agents: Sequence, device=None,
                       rollout_len: int = 1):
    """Returns ``step(loop, obs, horizon, states, ep_ret, generator=None,
    draws=None) -> (obs, metrics)`` over a ``ppo.HorizonBuffer`` of exactly
    ``rollout_len`` ticks of the loop's envs, refilled from its first row
    each superstep."""
    dev = resolve_device(device)
    n = cfg.n_agents
    act_dims = tuple(cfg.action_dim_n)

    def step(loop: TickLoop, obs: tuple, horizon: ppo_lib.HorizonBuffer,
             states: List, ep_ret: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Tuple[
                 Sequence[D.TickDraws],
                 Sequence[Sequence[D.PPOEpochDraws]]]] = None):
        ring = horizon.ring
        if (horizon.T, horizon.B) != (rollout_len, loop.B):
            raise ValueError(f"horizon of {horizon.T} x {horizon.B} rows for "
                             f"{rollout_len} ticks of {loop.B} envs")
        ring.ptr, ring.filled = 0, 0
        stats = torch.zeros(n + 2, dtype=torch.float32, device=dev)
        for t in range(rollout_len):
            td = (draws[0][t] if draws is not None else
                  D.make_tick_draws(loop.B, act_dims, False, generator, dev,
                                    loop.dtype))
            actions = torch.empty(loop.B, sum(act_dims),
                                  dtype=agents[0].dtype, device=dev)
            logp = horizon.logp[t * loop.B:(t + 1) * loop.B]
            col = 0
            for agent, st, o, noise, d in zip(agents, states, obs, td.policy,
                                              act_dims):
                agent.choose_action(st, o, noise, out=actions[:, col:col + d],
                                    logp=logp[:, col:col + d])
                col += d
            out = loop.step(actions, td.env)
            replay_lib.insert_tick(ring, obs, actions, out.reward,
                                   out.info["terminal_obs"], out.done,
                                   reset=out.reset_happened, ep_ret=ep_ret,
                                   stats=stats)
            obs = out.obs
        metrics = {"mean_reward": stats[n + 1] / (rollout_len * loop.B * n),
                   "fin_sum": stats[:n], "fin_cnt": stats[n]}
        epochs = (draws[1] if draws is not None else
                  D.make_ppo_epoch_draws(
                      rollout_len * loop.B, cfg.K_epochs, cfg.obs_dim_n,
                      [a.actor_widths for a in agents],
                      [a.critic_widths for a in agents], generator, dev,
                      agents[0].dtype))
        states, um = ppo_lib.train_step(cfg, agents, states,
                                        horizon.horizon(), epochs)
        metrics.update(um)
        return obs, metrics

    return step
