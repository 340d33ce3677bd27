"""Equivariant actors, twin Q critics and V critics (port of the TD3, SAC
and PPO parts of ``gym_rotor_tpu/models/emlp/zoo.py``: ``actor_reps``,
``critic_reps`` and ``v_critic_reps`` for the MONO and DTDE branches,
``EMLPActorDet``, ``EMLPActorSAC``, ``EMLPActorPPO``, ``EMLPCriticTwin``,
``EMLPVCritic``, ``emlp_twin_split``, ``td3_models``, ``sac_models`` and
``ppo_models``), for the MONO, DTDE and CTDE branches (a CTDE critic
takes every agent's obs, and a Q critic every agent's action, in agent
order).

Every network carries ``param_version`` (``models/mlp.py::Versioned``), an
explicit counter of in-place parameter writes: the flat optimizer bumps it
after each launch and the acting kernel's fold cache keys on it
(``kernels/emlp_actor.py``)."""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ...utils.config import Config
from ...utils.device import resolve_device
from ..mlp import LOG_SIG_MAX, LOG_SIG_MIN, Dense, Versioned
from . import groups as G
from .nn import EMLP, EMLPBlock, EquivLinear
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
    (zoo.py:56-75); under CTDE both agents' obs, then both actions, with
    the agent's own hidden group."""
    so2, t1, t3, mir = _groups()
    ch = cfg.critic_hidden_dim
    if framework == "MONO":
        rep_in = (Vector(so2) * 6 + Scalar(t1) * 2 + Vector(t3)
                  + Scalar(t1) + Vector(t3))
        hidden = uniform_rep(ch, so2)
    elif module_training == "CTDE":  # both agents' obs, then their actions
        rep_in = (Vector(so2) * 5 + Vector(mir) * 3
                  + Scalar(t1) + Vector(so2) + Vector(mir))
        hidden = uniform_rep(ch, so2 if agent_id == 0 else mir)
    elif agent_id == 0:  # MODUL1 DTDE
        rep_in = Vector(so2) * 5 + Scalar(t1) + Vector(so2)
        hidden = uniform_rep(ch, so2)
    else:  # MODUL2 DTDE
        rep_in = Vector(mir) * 4
        hidden = uniform_rep(ch, mir)
    return rep_in, hidden, Scalar(t1)


def v_critic_reps(cfg: Config, framework: str, agent_id: int,
                  module_training: str):
    """(rep_in, hidden_rep, rep_out) of the PPO V(s) critics, input obs only
    (zoo.py:78-95); under CTDE both agents' obs."""
    so2, t1, t3, mir = _groups()
    ch = cfg.critic_hidden_dim
    if framework == "MONO":
        rep_in = Vector(so2) * 6 + Scalar(t1) * 2 + Vector(t3)
        hidden = uniform_rep(ch, so2)
    elif module_training == "CTDE":  # both agents' obs
        rep_in = Vector(so2) * 5 + Vector(mir) * 3
        hidden = uniform_rep(ch, so2 if agent_id == 0 else mir)
    elif agent_id == 0:
        rep_in = Vector(so2) * 5
        hidden = uniform_rep(ch, so2)
    else:
        rep_in = Vector(mir) * 3
        hidden = uniform_rep(ch, mir)
    return rep_in, hidden, Scalar(t1)


class EMLPActorDet(Versioned):
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
        self.action_dim = rep_out.size

    def named_blocks(self, prefix: str = ""):
        return self.network.named_blocks(prefix + "network.")

    def named_head(self, prefix: str = ""):
        return self.network.named_head(prefix + "network.")

    def forward(self, obs, out: Optional[torch.Tensor] = None):
        from ...kernels.emlp_actor import emlp_actor
        return emlp_actor(self, obs, out)


class EMLPActorSAC(Versioned):
    """Gaussian EMLP actor (zoo.py:169-190): two equivariant blocks
    ``network_block0``/``network_block1``, the mean head ``network_head``
    (an ``EquivLinear``) and ``log_std_linear``, a plain ``Dense`` on the
    last hidden layer clipped to [LOG_SIG_MIN, LOG_SIG_MAX]; flax's names
    and layouts.  ``dist`` is the structured plain network.  ``forward`` is
    the acting sample ``tanh(mean + exp(log_std) noise)``, or ``tanh(mean)``
    without ``noise``: on CUDA tensors one launch of the fused actor kernel
    (K9), on CPU tensors ``dist`` and the plain sample."""

    def __init__(self, rep_in: SumRep, hidden: SumRep, rep_out: SumRep,
                 action_dim: int, hidden_num: int = 2, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype, generator=generator)
        reps = (rep_in,) + (hidden,) * hidden_num
        self.n_blocks = hidden_num
        for i, (rin, rout) in enumerate(zip(reps, reps[1:])):
            self.add_module(f"network_block{i}", EMLPBlock(rin, rout, **kw))
        self.network_head = EquivLinear(reps[-1], rep_out, **kw)
        self.log_std_linear = Dense(reps[-1].size, action_dim, **kw)
        self.action_dim = action_dim

    def named_blocks(self, prefix: str = ""):
        return [(f"{prefix}network_block{i}.",
                 getattr(self, f"network_block{i}"))
                for i in range(self.n_blocks)]

    def named_head(self, prefix: str = ""):
        return f"{prefix}network_head.", self.network_head

    def dist(self, obs):
        """``(mean, log_std)``, the policy head (zoo.py:179-190)."""
        x = obs
        for _, blk in self.named_blocks():
            x = blk(x)
        log_std = torch.clamp(self.log_std_linear(x), LOG_SIG_MIN, LOG_SIG_MAX)
        return self.network_head(x), log_std

    def forward(self, obs, noise: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None):
        from ...kernels.emlp_actor import sac_actor
        return sac_actor(self, obs, noise, out)


class EMLPCriticTwin(Versioned):
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


class EMLPActorPPO(Versioned):
    """PPO EMLP actor (zoo.py:193-213): ``mean = tanh(network(obs))`` and a
    learnable state-independent ``log_std`` of shape ``(1, action_dim)``,
    not clipped; flax's names, so the flat order starts with ``log_std``.
    ``dist`` is the structured plain network.  ``forward`` is the acting
    draw ``(action, per-dim log-prob)`` of ``ppo.py:107-116``, actions
    clipped to ``max_action`` (``cfg.max_action``): on CUDA tensors one
    launch of the fused actor kernel (K11), on CPU tensors ``dist`` and the
    plain draw."""

    def __init__(self, rep_in: SumRep, hidden: SumRep, rep_out: SumRep,
                 action_dim: int, hidden_num: int = 2,
                 log_std_init: float = 0.0, max_action: float = 1.0,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        reps = (rep_in,) + (hidden,) * hidden_num
        self.network = EMLP(reps, rep_out, device=device, dtype=dtype,
                            generator=generator)
        self.log_std = nn.Parameter(torch.full((1, action_dim), log_std_init,
                                               device=device, dtype=dtype))
        self.action_dim = action_dim
        self.max_action = float(max_action)

    def named_blocks(self, prefix: str = ""):
        return self.network.named_blocks(prefix + "network.")

    def named_head(self, prefix: str = ""):
        return self.network.named_head(prefix + "network.")

    def dist(self, obs):
        """``(mean, log_std)`` with ``log_std`` broadcast to ``mean``'s
        shape (zoo.py:205-213)."""
        mean = torch.tanh(self.network(obs))
        return mean, self.log_std.expand_as(mean)

    def forward(self, obs, noise: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None,
                logp: Optional[torch.Tensor] = None):
        from ...kernels.emlp_actor import ppo_actor
        return ppo_actor(self, obs, noise, out, logp)


class EMLPVCritic(Versioned):
    """Equivariant V(s) critic (zoo.py:216-228), one EMLP ``network``;
    ``forward`` is the structured plain network, the training path applies
    the same parameters through the block kernels (``algos/ppo.py``)."""

    def __init__(self, rep_in: SumRep, hidden: SumRep, rep_out: SumRep,
                 hidden_num: int = 2, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        reps = (rep_in,) + (hidden,) * hidden_num
        self.network = EMLP(reps, rep_out, device=device, dtype=dtype,
                            generator=generator)

    def forward(self, obs):
        return self.network(obs)


def emlp_twin_split(params):
    """Twin parameters (dotted names ``network1.*``/``network2.*``) ->
    (net1 params, net2 params), each renamed under ``network.``: a pure
    relabeling, as ``zoo.py:emlp_twin_split``."""
    out = ({}, {})
    for name, t in params.items():
        head, _, rest = name.partition(".")
        out[{"network1": 0, "network2": 1}[head]]["network." + rest] = t
    return out


def td3_models(cfg: Config, agent_id: int, device=None, dtype=torch.float32,
               generator: Optional[torch.Generator] = None):
    """``(EMLPActorDet, EMLPCriticTwin)`` of agent ``agent_id`` with seeded
    random weights (zoo.py:261-268)."""
    kw = dict(device=device, dtype=dtype, generator=generator)
    actor = EMLPActorDet(*actor_reps(cfg, cfg.framework, agent_id), **kw)
    critic = EMLPCriticTwin(*critic_reps(cfg, cfg.framework, agent_id,
                                         cfg.module_training), **kw)
    return actor, critic


def sac_models(cfg: Config, agent_id: int, device=None, dtype=torch.float32,
               generator: Optional[torch.Generator] = None):
    """``(EMLPActorSAC, EMLPCriticTwin)`` of agent ``agent_id`` with seeded
    random weights (zoo.py:271-278)."""
    kw = dict(device=device, dtype=dtype, generator=generator)
    actor = EMLPActorSAC(*actor_reps(cfg, cfg.framework, agent_id),
                         cfg.action_dim_n[agent_id], **kw)
    critic = EMLPCriticTwin(*critic_reps(cfg, cfg.framework, agent_id,
                                         cfg.module_training), **kw)
    return actor, critic


def ppo_models(cfg: Config, agent_id: int, device=None, dtype=torch.float32,
               generator: Optional[torch.Generator] = None):
    """``(EMLPActorPPO, EMLPVCritic)`` of agent ``agent_id`` with seeded
    random weights (zoo.py:281-287)."""
    kw = dict(device=device, dtype=dtype, generator=generator)
    actor = EMLPActorPPO(*actor_reps(cfg, cfg.framework, agent_id),
                         cfg.action_dim_n[agent_id],
                         max_action=cfg.max_action, **kw)
    critic = EMLPVCritic(*v_critic_reps(cfg, cfg.framework, agent_id,
                                        cfg.module_training), **kw)
    return actor, critic


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
