"""Model factory (port of ``gym_rotor_tpu/models/zoo.py``): an agent's
networks by ``cfg.use_equiv``, the equivariant EMLP networks
(``models/emlp/zoo.py``) or the plain MLPs (``models/mlp.py``), for TD3,
SAC and PPO, MODUL (DTDE or CTDE) or MONO.

Each factory returns ``(actor, critic)`` modules with seeded random weights
(flax's initializers' distributions, not its bits).  The MLP critics take
the agent's own obs (and action), or under MODUL CTDE every agent's
(``mlp.py:48-49``, ``:186-187``; JAX ``td3.py:116-119``, ``ppo.py:82``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.config import Config
from . import mlp
from .emlp import zoo as ezoo


def critic_in(cfg: Config, agent_id: int, with_action: bool) -> int:
    """An MLP critic's input width: the agent's obs (+ action), or under
    CTDE every agent's."""
    if cfg.is_ctde:
        return sum(cfg.obs_dim_n) + (sum(cfg.action_dim_n) if with_action
                                     else 0)
    return cfg.obs_dim_n[agent_id] + (cfg.action_dim_n[agent_id]
                                      if with_action else 0)


def td3_models(cfg: Config, agent_id: int, device=None, dtype=torch.float32,
               generator: Optional[torch.Generator] = None):
    """TD3's ``(actor, twin critic)`` of agent ``agent_id`` (zoo.py:28-37):
    ``EMLPActorDet``/``EMLPCriticTwin``, or ``ActorTD3``/``CriticTwin`` with
    hidden widths ``actor_hidden_dim[agent_id]`` and ``critic_hidden_dim``."""
    if cfg.use_equiv:
        return ezoo.td3_models(cfg, agent_id, device, dtype, generator)
    kw = dict(device=device, dtype=dtype, generator=generator)
    obs, act = cfg.obs_dim_n[agent_id], cfg.action_dim_n[agent_id]
    return (mlp.ActorTD3(obs, cfg.actor_hidden_dim[agent_id], act, **kw),
            mlp.CriticTwin(critic_in(cfg, agent_id, True),
                           cfg.critic_hidden_dim, **kw))


def sac_models(cfg: Config, agent_id: int, device=None, dtype=torch.float32,
               generator: Optional[torch.Generator] = None):
    """SAC's ``(actor, twin critic)`` (zoo.py:40-49): ``EMLPActorSAC``/
    ``EMLPCriticTwin``, or ``ActorSAC``/``CriticTwin``."""
    if cfg.use_equiv:
        return ezoo.sac_models(cfg, agent_id, device, dtype, generator)
    kw = dict(device=device, dtype=dtype, generator=generator)
    obs, act = cfg.obs_dim_n[agent_id], cfg.action_dim_n[agent_id]
    return (mlp.ActorSAC(obs, cfg.actor_hidden_dim[agent_id], act, **kw),
            mlp.CriticTwin(critic_in(cfg, agent_id, True),
                           cfg.critic_hidden_dim, **kw))


def ppo_models(cfg: Config, agent_id: int, device=None, dtype=torch.float32,
               generator: Optional[torch.Generator] = None):
    """PPO's ``(actor, V critic)`` (zoo.py:52-60): ``EMLPActorPPO``/
    ``EMLPVCritic``, or ``ActorPPO``/``VCritic``."""
    if cfg.use_equiv:
        return ezoo.ppo_models(cfg, agent_id, device, dtype, generator)
    kw = dict(device=device, dtype=dtype, generator=generator)
    obs, act = cfg.obs_dim_n[agent_id], cfg.action_dim_n[agent_id]
    return (mlp.ActorPPO(obs, cfg.actor_hidden_dim[agent_id], act,
                         max_action=cfg.max_action, **kw),
            mlp.VCritic(critic_in(cfg, agent_id, False),
                        cfg.critic_hidden_dim, **kw))
