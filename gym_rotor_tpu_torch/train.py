"""The training loop on one device (port of ``train.py:159-161, 343-425``,
``Learner.train_policy`` for TD3, SAC and PPO): seeded agents and envs,
then supersteps with the per-episode return log.  Off-policy (TD3, SAC): a
replay ring, the ``start_timesteps`` warm-up gate and the linear
exploration-noise decay (TD3 only, as ``train.py:421``);
``cfg.rl_algo == "SAC"`` builds ``SACAgent``s and runs the same superstep
with the SAC hooks (``algos/sac.py``).  On-policy (``"PPO"``,
``train.py:369-375``): each superstep is one horizon of ``max(T_horizon //
num_envs, 1)`` ticks and one full PPO update (``K_epochs`` of
minibatches), with no ring and no warm-up.

TD3, SAC and PPO each run every configuration the JAX package accepts:
MODUL (``module_training`` DTDE, or CTDE: MATD3 and the CTDE branches of
SAC and PPO) or MONO (``cfg.framework``), with EMLP or MLP networks
(``cfg.use_equiv``).  Not ported yet: periodic eval with best/solved actor
saving, checkpoints, resume and TensorBoard (ROADMAP Queue 1 item 1).

    from gym_rotor_tpu_torch.train import train
    out = train(Config(), supersteps=1000)             # TD3 on the card
    out = train(Config(framework="MONO", use_equiv=False), 1000)
    out = train(Config(rl_algo="SAC"), supersteps=1000)
    out = train(Config(rl_algo="PPO", num_envs=32), supersteps=100)
    out = train(Config(rl_algo="SAC", module_training="CTDE"), 1000)
    out = train(Config(num_envs=8, ...), 5, device="cpu")
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .algos import ppo as ppo_lib
from .algos import replay as replay_lib
from .algos import sac as sac_lib
from .algos.td3 import TD3Agent
from .envs.batch import batched_reset
from .kernels.env_tick import TickLoop
from .parallel.train_step import make_ppo_superstep, make_td3_superstep
from .utils.config import Config
from .utils.device import resolve_device


def train(cfg: Config, supersteps: int, device=None,
          on_superstep: Optional[Callable] = None,
          log: Optional[Callable] = print):
    """Run ``supersteps`` supersteps of ``cfg.num_envs * rollout_len``
    env-steps each.  Returns the run: a dict with the agents, their states,
    the ring (off-policy) or the horizon (PPO), the tick loop, the last obs,
    ``ep_ret``, ``total_timesteps``, ``noise_std`` and ``episodes``, the
    per-episode log ``(timestep, mean finished return per agent)``.
    ``on_superstep(i, warm, metrics, run)`` is called after each superstep
    (the caller's probe: timing, launch counts)."""
    if cfg.rl_algo not in ("TD3", "SAC", "PPO"):
        raise NotImplementedError(f"only TD3, SAC and PPO are ported, not "
                                  f"{cfg.rl_algo}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    init_gen = torch.Generator().manual_seed(cfg.seed)
    sac, ppo = cfg.rl_algo == "SAC", cfg.rl_algo == "PPO"
    agent_cls = (ppo_lib.PPOAgent if ppo else sac_lib.SACAgent if sac
                 else TD3Agent)
    agents = [agent_cls(cfg, i, dev) for i in range(cfg.n_agents)]
    states = [a.init(init_gen) for a in agents]
    bs, obs = batched_reset(cfg, gen, device=dev)
    loop = TickLoop(cfg, bs)
    ep_ret = torch.zeros(cfg.num_envs, cfg.n_agents, dtype=torch.float32,
                         device=dev)
    if ppo:
        rl = max(cfg.T_horizon // cfg.num_envs, 1)
        buf = ppo_lib.HorizonBuffer(cfg, rl, dev)
        step = make_ppo_superstep(cfg, agents, dev, rollout_len=rl)
    else:
        rl = max(cfg.rollout_len, 1)
        n_updates = max(int(round(cfg.updates_per_step * rl)), 1)
        buf = replay_lib.create(cfg.replay_buffer_size, cfg.obs_dim_n,
                                cfg.action_dim_n, device=dev)
        step = make_td3_superstep(
            cfg, agents, dev, rollout_len=rl, n_updates=n_updates,
            **(sac_lib.superstep_hooks(agents) if sac else {}))
    steps_per_call = cfg.num_envs * rl
    noise_std = cfg.explor_noise_std_init
    decay = ((cfg.explor_noise_std_init - cfg.explor_noise_std_min)
             / cfg.max_timesteps) if cfg.use_explor_noise_decay else 0.0
    run = dict(agents=agents, states=states, loop=loop, obs=obs,
               ep_ret=ep_ret, total_timesteps=0, noise_std=noise_std,
               episodes=[], **{"horizon" if ppo else "replay": buf})
    for i in range(supersteps):
        warm = not ppo and run["total_timesteps"] < cfg.start_timesteps
        if ppo:
            obs, metrics = step(loop, obs, buf, states, ep_ret, generator=gen)
        else:
            obs, metrics = step(loop, obs, buf, states, ep_ret, noise_std,
                                warm=warm, generator=gen)
        total = run["total_timesteps"] + steps_per_call
        fin_cnt = float(metrics["fin_cnt"])
        if fin_cnt > 0 and not warm:
            mean_ret = [round(float(r), 4)
                        for r in (metrics["fin_sum"] / fin_cnt).tolist()]
            run["episodes"].append((total, mean_ret))
            if log is not None:
                log(f"t={total} episode return {mean_ret}")
        if cfg.rl_algo == "TD3" and cfg.use_explor_noise_decay:
            noise_std = max(noise_std - decay * steps_per_call,
                            cfg.explor_noise_std_min)
        run.update(obs=obs, total_timesteps=total, noise_std=noise_std)
        if on_superstep is not None:
            on_superstep(i, warm, metrics, run)
    return run
