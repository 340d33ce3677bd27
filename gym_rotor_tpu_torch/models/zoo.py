"""Model factory (port of ``gym_rotor_tpu/models/zoo.py``): an agent's
networks by ``cfg.use_equiv``, the equivariant EMLP networks
(``models/emlp/zoo.py``) or the plain MLPs (``models/mlp.py``).

Each factory returns ``(actor, critic)`` modules with seeded random weights
(flax's initializers' distributions, not its bits).  TD3 has both families
for MODUL and MONO.  SAC and PPO have the EMLP networks for MODUL only: their
MLP networks (``ActorSAC``, ``ActorPPO``, ``VCritic``) and their MONO acting
kernel instances are not ported yet, and both raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.config import Config
from . import mlp
from .emlp import zoo as ezoo



def _sac_ppo(cfg: Config, algo: str):
    if not cfg.use_equiv or cfg.framework != "MODUL":
        raise NotImplementedError(
            f"{algo} with framework={cfg.framework!r}, use_equiv="
            f"{cfg.use_equiv}: only MODUL with EMLP networks is ported (the "
            "MONO and MLP networks of SAC and PPO are ROADMAP Queue 1 item "
            "13)")


def td3_models(cfg: Config, agent_id: int, device=None, dtype=torch.float32,
               generator: Optional[torch.Generator] = None):
    """TD3's ``(actor, twin critic)`` of agent ``agent_id`` (zoo.py:28-37):
    ``EMLPActorDet``/``EMLPCriticTwin``, or ``ActorTD3``/``CriticTwin`` with
    hidden widths ``actor_hidden_dim[agent_id]`` and ``critic_hidden_dim``."""
    if cfg.use_equiv:
        return ezoo.td3_models(cfg, agent_id, device, dtype, generator)
    if cfg.framework == "MODUL" and cfg.module_training == "CTDE":
        raise NotImplementedError("the CTDE critics are not ported yet")
    kw = dict(device=device, dtype=dtype, generator=generator)
    obs, act = cfg.obs_dim_n[agent_id], cfg.action_dim_n[agent_id]
    return (mlp.ActorTD3(obs, cfg.actor_hidden_dim[agent_id], act, **kw),
            mlp.CriticTwin(obs + act, cfg.critic_hidden_dim, **kw))


def sac_models(cfg: Config, agent_id: int, device=None, dtype=torch.float32,
               generator: Optional[torch.Generator] = None):
    """SAC's ``(actor, twin critic)`` (zoo.py:40-49); MODUL EMLP only."""
    _sac_ppo(cfg, "SAC")
    return ezoo.sac_models(cfg, agent_id, device, dtype, generator)


def ppo_models(cfg: Config, agent_id: int, device=None, dtype=torch.float32,
               generator: Optional[torch.Generator] = None):
    """PPO's ``(actor, V critic)`` (zoo.py:52-60); MODUL EMLP only."""
    _sac_ppo(cfg, "PPO")
    return ezoo.ppo_models(cfg, agent_id, device, dtype, generator)
