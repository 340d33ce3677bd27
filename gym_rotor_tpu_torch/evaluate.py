"""Batched evaluation rollout (port of ``train.py::benchmark_reward`` and
``build_eval_rollout`` with ``eval_stream="parallel"``): the
``--test_model`` path, i.e. the trained actors answering requests.

``cfg.num_eval`` eval envs (nominal params) step in lockstep for
``eval_max_steps`` seconds under the joint deterministic policy; an env
stops counting at its first crash.  The ``reference`` eval stream and the
flight-log rows are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .envs import draws as D
from .envs.batch import batched_reset
from .envs.quad import DT
from .kernels.env_tick import TickLoop
from .utils.config import Config
from .utils.device import resolve_device

EVAL_SEED = 1992


def benchmark_reward(ex, eb1):
    """interp(-||ex|| - |eb1|, [-2, 0], [0, 1])."""
    r = -torch.linalg.vector_norm(ex, dim=-1) - torch.abs(eb1)
    return torch.clamp((r + 2.0) / 2.0, 0.0, 1.0)


def joint_policy(actors: Sequence[torch.nn.Module]):
    """``act(obs_tuple) -> (B, sum act dims)``: each actor writes its
    deterministic action into its columns of the joint action in place
    (``train.py:193-206``): a TD3 actor's action, a SAC actor's
    ``tanh(mean)``, a PPO actor's ``clip(mean)``; for an EMLP actor one
    kernel launch on CUDA (K3, K9 or K11), for an MLP actor its
    ``F.linear`` chain (and, PPO's, K11's head)."""
    dims = [a.action_dim for a in actors]

    def act(obs):
        out = torch.empty(obs[0].shape[0], sum(dims), dtype=torch.float32,
                          device=obs[0].device)
        col = 0
        with torch.no_grad():
            for actor, o, n in zip(actors, obs, dims):
                actor(o, out=out[:, col:col + n])
                col += n
        return out
    return act


def evaluate(cfg: Config, actors: Sequence[torch.nn.Module],
             generator: Optional[torch.Generator] = None, device=None,
             init: Optional[tuple] = None):
    """Returns ``(mean episode reward per agent, mean benchmark reward,
    success (num_eval, n_agents), mean last |ex|, mean last eb1)`` as in
    ``train.build_eval_rollout``.  Entry point: runs on the card unless
    ``device="cpu"``.  ``init = (state, obs)`` starts from given eval
    states (parity tests) instead of a seeded reset."""
    if cfg.eval_stream != "parallel":
        raise NotImplementedError("only eval_stream='parallel' is ported")
    dev = resolve_device(device)
    eval_cfg = cfg.replace(num_envs=cfg.num_eval)
    eval_steps = int(round(cfg.eval_max_steps / DT))
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(EVAL_SEED)
    if init is None:
        bs, obs = batched_reset(eval_cfg, generator, "eval", device=dev)
    else:
        bs, obs = init
    act = joint_policy(actors)
    loop = TickLoop(eval_cfg, bs, "eval")
    n = eval_cfg.num_envs
    f32 = dict(dtype=torch.float32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    ep_rwd = torch.zeros(n, cfg.n_agents, **f32)
    bench = torch.zeros(n, **f32)
    last_ex = torch.zeros(n, 3, **f32)
    last_eb1 = torch.zeros(n, **f32)
    for _ in range(eval_steps):
        action = act(obs)
        draws = D.draw_uniforms(n, generator, loop.dtype, dev)
        out = loop.step(action, draws)
        a = active[:, None]
        ep_rwd = ep_rwd + torch.where(a, out.reward, 0.0)
        bench = bench + torch.where(
            active, benchmark_reward(out.info["ex"], out.info["eb1"]), 0.0)
        last_ex = torch.where(a, out.info["ex"], last_ex)
        last_eb1 = torch.where(active, out.info["eb1"], last_eb1)
        active = active & ~out.info["crashed"].any(-1)
        obs = out.obs
    # success: a full-length episode with |ex| <= 0.01, and for MODUL's
    # agent 1 |eb1| <= 0.01 (train.py:133-140)
    succ_pos = active & (torch.abs(last_ex) <= 0.01).all(-1)
    if cfg.framework == "MODUL":
        succ_yaw = active & (torch.abs(last_eb1) <= 0.01)
        success = torch.stack([succ_pos, succ_yaw], dim=-1)
    else:
        success = succ_pos[:, None]
    return (ep_rwd.mean(0), bench.mean(0), success, last_ex.mean(0),
            last_eb1.mean(0))
