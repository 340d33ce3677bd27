"""Batched evaluation rollout (port of ``train.py::benchmark_reward`` and
``build_eval_rollout``): the ``--test_model`` path, i.e. the trained actors
answering requests.

``cfg.num_eval`` eval envs (nominal params) step in lockstep for
``eval_max_steps`` seconds under the joint deterministic policy; an env
stops counting at its first crash.  ``eval_stream="parallel"`` starts them
from a seeded reset (K1's reset entry on the card); ``"reference"`` from
the reference's own 10 fixed-seed episodes (``envs/ref_stream.py``, lifted
in plain torch).  With ``cfg.save_log`` or ``cfg.render`` each tick also
gives env 0's flight-log row (``train.py:107-119``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .envs import draws as D
from .envs.batch import batched_reset
from .envs.dynamics import dot3
from .envs.quad import DT
from .envs.ref_stream import batched_reset_reference
from .envs.state import pack_state
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
    ``F.linear`` chain (PPO's: one launch of its fused forward with K11's
    head)."""
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


def _log_row(env, action, eb1):
    """Env 0's flight-log row (``train.py:107-119``): ``[action | state18,
    eIx, eb1, eIb1 | xd, vd, b1c, Wd]``, from the state after the tick
    (after any reset) and the tick's ``eb1``."""
    x, v, R, W = env.x[0], env.v[0], env.R[0], env.W[0]
    g = env.goal
    b3 = R[:, 2]
    b1c = g.b1d[0] - dot3(g.b1d[0], b3) * b3
    return torch.cat([action[0], pack_state(x, v, R, W), env.eIx[0],
                      eb1[0:1], env.eIb1[0:1], g.xd[0], g.vd[0], b1c,
                      g.Wd[0]])


def evaluate(cfg: Config, actors: Sequence[torch.nn.Module],
             generator: Optional[torch.Generator] = None, device=None,
             init: Optional[tuple] = None,
             draws: Optional[torch.Tensor] = None):
    """Returns ``(mean episode reward per agent, mean benchmark reward,
    success (num_eval, n_agents), mean last |ex|, mean last eb1, rows)`` as
    ``train.build_eval_rollout`` does; ``rows`` is ``(eval ticks, action
    width + 35)`` when ``cfg.save_log or cfg.render``, else None.  Entry
    point: runs on the card unless ``device="cpu"``.  The parity tests pass
    ``init = (state, obs)`` to start from given eval states, and ``draws``
    ``(eval ticks, num_eval, N_DRAWS)`` for the ticks' base draws in place
    of the generator's."""
    if cfg.eval_stream not in ("parallel", "reference"):
        raise ValueError(f"unknown eval_stream {cfg.eval_stream!r}: "
                         "expected 'parallel' or 'reference'")
    dev = resolve_device(device)
    eval_cfg = cfg.replace(num_envs=cfg.num_eval)
    eval_steps = int(round(cfg.eval_max_steps / DT))
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(EVAL_SEED)
    if init is not None:
        bs, obs = init
    elif cfg.eval_stream == "reference":
        bs, obs = batched_reset_reference(eval_cfg, EVAL_SEED, device=dev)
    else:
        bs, obs = batched_reset(eval_cfg, generator, "eval", device=dev)
    act = joint_policy(actors)
    loop = TickLoop(eval_cfg, bs, "eval")
    n = eval_cfg.num_envs
    f32 = dict(dtype=torch.float32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    ep_rwd = torch.zeros(n, cfg.n_agents, **f32)
    bench = torch.zeros(n, **f32)
    last_ex = torch.zeros(n, 3, **f32)
    last_eb1 = torch.zeros(n, **f32)
    rows = [] if cfg.save_log or cfg.render else None
    for k in range(eval_steps):
        action = act(obs)
        u = draws[k] if draws is not None else \
            D.draw_uniforms(n, generator, loop.dtype, dev)
        out = loop.step(action, u)
        a = active[:, None]
        ep_rwd = ep_rwd + torch.where(a, out.reward, 0.0)
        bench = bench + torch.where(
            active, benchmark_reward(out.info["ex"], out.info["eb1"]), 0.0)
        last_ex = torch.where(a, out.info["ex"], last_ex)
        last_eb1 = torch.where(active, out.info["eb1"], last_eb1)
        active = active & ~out.info["crashed"].any(-1)
        obs = out.obs
        if rows is not None:
            rows.append(_log_row(loop.state.env, action, out.info["eb1"]))
    # success: a full-length episode with |ex| <= 0.01, and for MODUL's
    # agent 1 |eb1| <= 0.01 (train.py:133-140)
    succ_pos = active & (torch.abs(last_ex) <= 0.01).all(-1)
    if cfg.framework == "MODUL":
        succ_yaw = active & (torch.abs(last_eb1) <= 0.01)
        success = torch.stack([succ_pos, succ_yaw], dim=-1)
    else:
        success = succ_pos[:, None]
    return (ep_rwd.mean(0), bench.mean(0), success, last_ex.mean(0),
            last_eb1.mean(0), None if rows is None else torch.stack(rows))
