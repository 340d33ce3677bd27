"""Batched lockstep environments with auto-reset (port of
``gym_rotor_tpu/envs/batch.py``).

``batched_step`` is the K1 tick.  On CUDA tensors it is one launch of the
hand-written kernel ``kernels/csrc/env_tick.cu``; on CPU tensors it runs
``batched_step_plain``, the dense PyTorch twin that mirrors the JAX tick
line by line (fresh episode for every env, then a select).  Random draws
are injected per tick (``envs/draws.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.tree import select, tree_map
from . import draws as D
from . import quad
from .state import EnvState
from .trajectory import TrajState, get_desired, mark_traj_start


@dataclass
class BatchedEnvState:
    env: EnvState
    traj: TrajState


class BatchedStepOut(NamedTuple):
    obs: tuple              # per agent, float32: MODUL (B, 15), (B, 3);
    #                         MONO (B, 23)
    reward: torch.Tensor    # (B, n_agents)
    done: torch.Tensor      # (B, n_agents) bool, done recorded for training
    reset_happened: torch.Tensor  # (B,) bool
    info: dict


class Transition(NamedTuple):
    obs: tuple
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: tuple
    done: torch.Tensor


def _fresh(cfg: Config, u, env_type: str):
    """Fresh episode for every row of ``u`` (batch.py:109-117)."""
    ns = quad.reset_state(cfg, u, env_type)
    batch, dtype, device = u.shape[:-1], u.dtype, u.device
    ts = TrajState.create(batch, dtype, device)
    ts = mark_traj_start(ts, ns.x, ns.R)
    ts, goal = get_desired(ts, ns.x, ns.v, ns.R, ns.W, cfg.train_traj_mode,
                           D.traj_draws(u, fresh=True))
    ns = dataclasses.replace(ns, goal=goal)
    ns, obs = quad.initial_obs(cfg, ns)
    return ns, ts, obs


def batched_reset_plain(cfg: Config, draws: torch.Tensor,
                        env_type: str = "train"):
    """Reset ``draws.shape[0]`` envs (batch.py:48-72) in plain PyTorch."""
    env, traj, obs = _fresh(cfg, draws, env_type)
    return BatchedEnvState(env=env, traj=traj), obs


def batched_reset(cfg: Config, generator: Optional[torch.Generator] = None,
                  env_type: str = "train", dtype=torch.float32, device=None,
                  draws: Optional[torch.Tensor] = None):
    """Reset ``cfg.num_envs`` envs and return ``(state, obs)``, ``obs`` one
    array per agent (``(obs1, obs2)`` for MODUL, ``(obs,)`` for MONO).

    Entry point: runs on the card unless ``device="cpu"``.  On CUDA the
    fresh chain is the env-tick kernel's reset entry; on the CPU it is the
    plain twin.  ``draws`` (``(num_envs, N_DRAWS)``) overrides the
    generator, for parity tests."""
    from ..kernels import env_tick
    dev = resolve_device(device)
    if draws is None:
        draws = D.draw_uniforms(cfg.num_envs, generator, dtype, dev)
    elif draws.shape != (cfg.num_envs, D.N_DRAWS):
        raise ValueError(f"draws must be ({cfg.num_envs}, {D.N_DRAWS}), "
                         f"got {tuple(draws.shape)}")
    return env_tick.env_reset(cfg, draws.to(dev, dtype), env_type)


def batched_step_plain(cfg: Config, bstate: BatchedEnvState, actions,
                       draws, env_type: str = "train"):
    """Dense PyTorch twin of the K1 tick (batch.py:75-162)."""
    traj, goal = get_desired(bstate.traj, bstate.env.x, bstate.env.v,
                             bstate.env.R, bstate.env.W, cfg.train_traj_mode,
                             D.traj_draws(draws))
    env = dataclasses.replace(bstate.env, goal=goal)
    env2, out = quad.step(cfg, env, actions)

    at_cap = env2.t >= cfg.max_steps
    crashed = out.done
    ex = out.info["ex"]
    solved_pos = (torch.abs(ex) <= 0.03).all(-1)
    if cfg.framework == "MODUL":
        solved_yaw = torch.abs(out.info["eb1"]) <= 0.03
        solved = torch.stack([solved_pos & (out.reward[..., 0] != -1.0),
                              solved_yaw & (out.reward[..., 1] != -1.0)],
                             dim=-1)
    else:
        solved = (solved_pos & (out.reward[..., 0] != -1.0))[..., None]
    done_recorded = torch.where(at_cap[..., None], solved, crashed)
    episode_over = crashed.any(-1) | at_cap

    fresh_env, fresh_traj, fresh_obs = _fresh(cfg, draws, env_type)
    env_next = select(episode_over, fresh_env, env2)
    traj_next = select(episode_over, fresh_traj, traj)
    obs_next = tuple(torch.where(episode_over[..., None], f, c)
                     for f, c in zip(fresh_obs, out.obs))
    return (BatchedEnvState(env=env_next, traj=traj_next),
            BatchedStepOut(obs=obs_next, reward=out.reward, done=done_recorded,
                           reset_happened=episode_over,
                           info={**out.info, "terminal_obs": out.obs,
                                 "crashed": crashed}))


def batched_step(cfg: Config, bstate: BatchedEnvState, actions: torch.Tensor,
                 draws: torch.Tensor, env_type: str = "train"):
    """One lockstep tick for all envs: get_desired -> step -> cap/solved
    override -> auto-reset.  ``actions`` is ``(B, 5)`` (MODUL) or ``(B, 4)``
    (MONO), ``draws``
    ``(B, N_DRAWS)``.  Launches the K1 kernel on CUDA tensors."""
    from ..kernels import env_tick
    return env_tick.env_tick(cfg, bstate, actions, draws, env_type)


def _stack(items):
    return tree_map(lambda *xs: torch.stack(xs), *items)


def rollout(cfg: Config, bstate: BatchedEnvState, obs: tuple,
            policy_fn: Callable, num_steps: int,
            generator: Optional[torch.Generator], env_type: str = "train"):
    """``num_steps`` lockstep ticks under ``policy_fn(obs) -> (B, act)``
    (batch.py:200-227).  Returns the final state and obs and the stacked
    time-major ``Transition``s and ``BatchedStepOut``s.  On the card the
    state stays packed between ticks (``env_tick.TickLoop``)."""
    from ..kernels.env_tick import TickLoop
    loop = TickLoop(cfg, bstate, env_type)
    trs, outs = [], []
    for _ in range(num_steps):
        actions = policy_fn(obs)
        draws = D.draw_uniforms(loop.B, generator, loop.dtype, loop.device)
        out = loop.step(actions, draws)
        trs.append(Transition(obs=obs, action=actions, reward=out.reward,
                              next_obs=out.info["terminal_obs"], done=out.done))
        outs.append(out)
        obs = out.obs
    return loop.state, obs, _stack(trs), _stack(outs)
