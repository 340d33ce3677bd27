"""Equivariant actors (port of the TD3 part of
``gym_rotor_tpu/models/emlp/zoo.py``: ``actor_reps`` and
``EMLPActorDet``).  Critics, SAC and PPO heads wait for the training
slice."""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ...utils.config import Config
from ...utils.device import resolve_device
from . import groups as G
from .nn import EMLP
from .reps import Scalar, SumRep, Vector, uniform_rep


def _groups():
    return G.SO2eR3(), G.Trivial(1), G.Trivial(3), G.Mirror(1)


def actor_reps(cfg: Config, framework: str, agent_id: int):
    """(rep_in, hidden_rep, rep_out) per actor (zoo.py:37-53)."""
    so2, t1, t3, mir = _groups()
    ah = cfg.actor_hidden_dim[agent_id]
    if framework == "MONO":
        rep_in = Vector(so2) * 6 + Scalar(t1) * 2 + Vector(t3)
        rep_out = Scalar(t1) + Vector(t3)
        hidden = uniform_rep(ah, so2)
    elif agent_id == 0:  # MODUL1
        rep_in = Vector(so2) * 5
        rep_out = Scalar(t1) + Vector(so2)
        hidden = uniform_rep(ah, so2)
    else:  # MODUL2
        rep_in = Vector(mir) * 3
        rep_out = Vector(mir)
        hidden = uniform_rep(ah, mir)
    return rep_in, hidden, rep_out


class EMLPActorDet(nn.Module):
    """Deterministic tanh EMLP actor (zoo.py:101-113).  On CUDA tensors the
    forward is one launch of the fused actor kernel (K3); on CPU tensors it
    is the structured plain network."""

    def __init__(self, rep_in: SumRep, hidden: SumRep, rep_out: SumRep,
                 hidden_num: int = 2, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        reps = (rep_in,) + (hidden,) * hidden_num
        self.network = EMLP(reps, rep_out, device=device, dtype=dtype,
                            generator=generator)

    def forward(self, obs, out: Optional[torch.Tensor] = None):
        from ...kernels.emlp_actor import emlp_actor
        return emlp_actor(self, obs, out)


def make_actors(cfg: Config, device=None, dtype=torch.float32,
                seed: int = 0) -> List[EMLPActorDet]:
    """One deterministic actor per agent with seeded random weights."""
    device = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    actors = []
    for i in range(cfg.n_agents):
        rin, hid, rout = actor_reps(cfg, cfg.framework, i)
        actor = EMLPActorDet(rin, hid, rout, device="cpu", dtype=dtype,
                             generator=gen)
        actors.append(actor.to(device))
    return actors
