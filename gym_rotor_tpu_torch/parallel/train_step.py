"""The actor-learner supersteps on one device or over a process group
(port of ``gym_rotor_tpu/parallel/train_step.py``).

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

Over a process group (``mesh``, ``parallel/mesh.py``; JAX's ``shard_map``
over the ``env`` axis) each rank steps its own envs (its share of the
global batch) into its own ring or horizon, with its own draws, and the
agents' states are replicated: every flat gradient is averaged over the
ranks before its K6 step (``parallel/mesh.py::pmean``).  Off-policy
updates sample ``max(batch_size // world, 1)`` rows of the rank's ring
(``train_step.py:89``); PPO runs its minibatches over the rank's horizon
(GAE normalised over every rank's, ``kernels/gae.py::gae_sharded``).  The
metrics go out reduced as JAX's (``:162-166``, ``:183``, ``:280-285``):
``fin_sum`` and ``fin_cnt`` summed, ``mean_reward`` and the losses
averaged, all in one all-reduce of one packed buffer at the end of the
superstep, so every host decision read from them is the same on every
rank.  SAC's temperature is not reduced (``sac.py:264-271``): each rank
keeps its own ``log_alpha``, as each JAX device does.  Without a mesh or
at world 1 nothing is reduced and the step is the one-device step, so a
``mesh`` argument, not JAX's separate ``make_sharded_*`` functions, carries
the one path for any device count that JAX's driver has.
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
from . import mesh as mesh_lib
from .mesh import Mesh


def reduce_metrics(metrics: dict, mesh: Optional[Mesh]) -> dict:
    """The superstep's metrics over the ranks, in one all-reduce of one
    buffer: ``fin_sum`` and ``fin_cnt`` summed (``psum``), every other
    entry (``mean_reward``, the losses, SAC's ``alpha``) averaged
    (``pmean``: the sum divided by the world size).  ``metrics`` as the
    step made them, in the same order and dtypes; unchanged without a mesh
    or at world 1."""
    if mesh is None or not mesh.sharded:
        return metrics
    keys = list(metrics)
    vals = [metrics[k] for k in keys]
    dtype = vals[0].dtype
    for v in vals[1:]:
        dtype = torch.promote_types(dtype, v.dtype)
    sizes = [v.numel() for v in vals]
    buf = torch.cat([v.reshape(-1).to(dtype) for v in vals])
    mesh_lib.psum(buf, mesh)
    out = {}
    for k, v, part in zip(keys, vals, torch.split(buf, sizes)):
        if k not in ("fin_sum", "fin_cnt"):
            part = part / mesh.world
        out[k] = part.reshape(v.shape).to(v.dtype)
    return out


def make_td3_superstep(cfg: Config, agents: Sequence, device=None,
                       rollout_len: int = 1, n_updates: int = 1,
                       train_fn: Optional[Callable] = None,
                       act_fn: Optional[Callable] = None,
                       draws_fn: Optional[Callable] = None,
                       stack: Sequence[str] = td3_lib.CAPS_STACK,
                       mesh: Optional[Mesh] = None):
    """Returns ``step(loop, obs, rstate, states, ep_ret, noise_std,
    warm=False, generator=None, draws=None) -> (obs, metrics)``.

    ``train_fn(cfg, agents, states, batch, agent_draws, mesh=) ->
    (states, metrics)`` is the update (default ``td3.train_step``);
    ``act_fn(states, obs, noise_std, policy_draws) -> joint action`` the
    train ticks' policy (default TD3's noisy deterministic actors);
    ``draws_fn`` makes an update's
    ``UpdateDraws`` with ``envs/draws.py::make_update_draws``'s signature
    (default that function; ``ctde`` set for a MODUL CTDE ``cfg``);
    ``stack`` the learner's CAPS stack, which each sample writes with the
    other operands (``algos/replay.py::sample``; default TD3's); ``mesh``
    the process group the step runs over, None for one device."""
    dev = resolve_device(device)
    n = cfg.n_agents
    act_dims = tuple(cfg.action_dim_n)
    m = cfg.max_action
    train_fn = train_fn or td3_lib.train_step
    draws_fn = draws_fn or D.make_update_draws
    world = mesh.world if mesh is not None else 1
    local_batch = max(cfg.batch_size // world, 1)        # train_step.py:89

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
            return obs, reduce_metrics(metrics, mesh)
        for u in range(n_updates):
            ud = (draws[1][u] if draws is not None else
                  draws_fn(local_batch, rstate.filled, cfg.obs_dim_n,
                           act_dims, [a.critic_widths for a in agents],
                           [a.actor_widths for a in agents], generator, dev,
                           agents[0].dtype, ctde=cfg.is_ctde))
            batch = replay_lib.sample(rstate, local_batch, idx=ud.idx,
                                      ctde=cfg.is_ctde, stack=tuple(stack))
            states, um = train_fn(cfg, agents, states, batch, ud.agents,
                                  mesh=mesh)
        metrics.update(um)
        return obs, reduce_metrics(metrics, mesh)

    return step


def make_ppo_superstep(cfg: Config, agents: Sequence, device=None,
                       rollout_len: int = 1, mesh: Optional[Mesh] = None):
    """Returns ``step(loop, obs, horizon, states, ep_ret, generator=None,
    draws=None) -> (obs, metrics)`` over a ``ppo.HorizonBuffer`` of exactly
    ``rollout_len`` ticks of the loop's envs (the rank's, over ``mesh``),
    refilled from its first row each superstep."""
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
                                        horizon.horizon(), epochs, mesh=mesh)
        metrics.update(um)
        return obs, reduce_metrics(metrics, mesh)

    return step


def shard_replay(rstate: replay_lib.ReplayState, mesh: Optional[Mesh]
                 ) -> replay_lib.ReplayState:
    """This rank's ring of a global ring (``train_step.py:341``
    ``shard_replay``): the global ring is the ranks' rings concatenated in
    rank order, as JAX's capacity-sharded array is, so rank ``r`` takes
    rows ``[r C, (r + 1) C)`` of ``C = capacity / world``; ``ptr`` and
    ``filled`` (each rank's cursor, the same on every rank) carry over.
    The global ring itself at world 1."""
    if mesh is None or not mesh.sharded:
        return rstate
    return replay_lib.ReplayState(
        data=mesh_lib.shard_batch(rstate.data, mesh), ptr=int(rstate.ptr),
        filled=int(rstate.filled), dims=rstate.dims)
