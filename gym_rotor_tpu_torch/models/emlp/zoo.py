"""Equivariant actors and twin Q critics (port of the TD3 part of
``gym_rotor_tpu/models/emlp/zoo.py``: ``actor_reps``, ``critic_reps`` for
the MONO and DTDE branches, ``EMLPActorDet``, ``EMLPCriticTwin`` and
``emlp_twin_split``).  SAC and PPO heads and the CTDE critic reps are not
ported yet.

Every network carries ``param_version``, an explicit counter of in-place
parameter writes: the flat optimizer bumps it after each launch and the
acting kernel's fold cache keys on it (``kernels/emlp_actor.py``)."""
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


def critic_reps(cfg: Config, framework: str, agent_id: int,
                module_training: str):
    """(rep_in, hidden_rep, rep_out) of the Q critics, input obs + action
    (zoo.py:56-75)."""
    so2, t1, t3, mir = _groups()
    ch = cfg.critic_hidden_dim
    if module_training == "CTDE" and framework != "MONO":
        raise NotImplementedError("CTDE critics are not ported yet")
    if framework == "MONO":
        rep_in = (Vector(so2) * 6 + Scalar(t1) * 2 + Vector(t3)
                  + Scalar(t1) + Vector(t3))
        hidden = uniform_rep(ch, so2)
    elif agent_id == 0:  # MODUL1 DTDE
        rep_in = Vector(so2) * 5 + Scalar(t1) + Vector(so2)
        hidden = uniform_rep(ch, so2)
    else:  # MODUL2 DTDE
        rep_in = Vector(mir) * 4
        hidden = uniform_rep(ch, mir)
    return rep_in, hidden, Scalar(t1)


class _Versioned(nn.Module):
    """``param_version`` counts in-place parameter writes; moving or loading
    the module counts as one too."""

    def __init__(self):
        super().__init__()
        self.param_version = 0

    def bump_version(self):
        self.param_version += 1

    def _apply(self, fn, *args, **kwargs):
        self.param_version += 1
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        out = super().load_state_dict(*args, **kwargs)
        self.param_version += 1
        return out


class EMLPActorDet(_Versioned):
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


class EMLPCriticTwin(_Versioned):
    """Twin equivariant Q networks over concat(obs, act) (zoo.py:116-139),
    ``network1`` and ``network2``.  ``forward`` and ``q1`` are the
    structured plain networks; the training path applies the same
    parameters through the block kernels (``algos/td3.py``)."""

    def __init__(self, rep_in: SumRep, hidden: SumRep, rep_out: SumRep,
                 hidden_num: int = 2, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        reps = (rep_in,) + (hidden,) * hidden_num
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.network1 = EMLP(reps, rep_out, **kw)
        self.network2 = EMLP(reps, rep_out, **kw)

    def forward(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        return self.network1(x), self.network2(x)

    def q1(self, obs, act):
        return self.network1(torch.cat([obs, act], dim=-1))


def emlp_twin_split(params):
    """Twin parameters (dotted names ``network1.*``/``network2.*``) ->
    (net1 params, net2 params), each renamed under ``network.``: a pure
    relabeling, as ``zoo.py:emlp_twin_split``."""
    out = ({}, {})
    for name, t in params.items():
        head, _, rest = name.partition(".")
        out[{"network1": 0, "network2": 1}[head]]["network." + rest] = t
    return out


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
