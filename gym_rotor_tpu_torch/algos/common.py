"""Learner plumbing (port of ``gym_rotor_tpu/algos/common.py``): the
cosine warm-restart schedule, the flat optimizer chain (clip to the global
norm, then AdamW, with optax's semantics), flat Polyak averaging and mse;
and what the TD3, SAC and PPO learners share: ``FlatAgent`` and the
spectral-norm penalty on a network's parameter views.

Flat parameters: each network's parameters are views into ONE flat leaf in
``ravel_pytree`` order (the dotted flax paths sorted as path tuples, which
is the order jax flattens a flax dict tree), so a loss's gradient arrives
as one vector and the optimizer state (``mu``, ``nu``) is one vector each,
as in the JAX flat update path.  The network module's own parameters are
bound to views of the same flat tensor (``bind_flat``), so the acting
kernel reads what the optimizer writes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.emlp_block import emlp_apply
from ..kernels.flat_adamw import StepScalars, flat_adamw
from ..models import mlp
from ..models.emlp.nn import spectral_weights
from ..utils.config import Config
from ..utils.device import resolve_device
from . import regularizers


def cosine_warm_restarts(base_lr: float, t0: int = 1_000_000,
                         eta_min: float = 1e-5):
    """``schedule(count) -> lr``: CosineAnnealingWarmRestarts(T_0=1e6,
    eta_min=1e-5), evaluated on the host in float32 in the JAX schedule's
    order of operations (``common.py:25-35``), so the step matches optax's."""
    f32 = np.float32
    half_range = f32((base_lr - eta_min) * 0.5)

    def schedule(count: int) -> float:
        t = f32(np.mod(f32(count), f32(t0)) / f32(t0))
        return float(f32(eta_min) + half_range
                     * (f32(1.0) + np.cos(f32(np.pi) * t)))
    return schedule


class FlatLayout:
    """Names, shapes and offsets of a network's parameters in the flat
    vector (``ravel_pytree`` order)."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]]):
        self.names = sorted(shapes, key=lambda n: tuple(n.split(".")))
        self.shapes = [tuple(shapes[n]) for n in self.names]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).tolist()
        self.size = int(self.offsets[-1])

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: flat[o:o + k].view(s) for n, o, k, s in
                zip(self.names, self.offsets, self.sizes, self.shapes)}

    def ravel(self, named: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([named[n].reshape(-1) for n in self.names])


def flat_layout(module: torch.nn.Module) -> FlatLayout:
    return FlatLayout({n: tuple(p.shape) for n, p in module.named_parameters()})


def bind_flat(module: torch.nn.Module, flat: torch.Tensor) -> None:
    """Make ``module``'s parameters views of ``flat`` (same storage) and
    count it as a parameter write."""
    views = flat_layout(module).views(flat.detach())
    for name, p in module.named_parameters():
        p.data = views[name]
    module.bump_version()


@dataclass
class OptState:
    """The optax chain's state over one flat vector: ``ScaleByAdamState``
    (``count``, ``mu``, ``nu``) and ``ScaleByScheduleState.count``
    (``sched_count``); the counts are host integers."""
    count: int
    mu: torch.Tensor
    nu: torch.Tensor
    sched_count: int


class FlatAdamW:
    """``make_optimizer``: clip to ``cfg.grad_max_norm`` (when
    ``cfg.use_clip_grad_norm``), then AdamW (0.9, 0.999, 1e-8, weight
    decay 1e-2) at ``cosine_warm_restarts(base_lr)``; one K6 call per
    update (``kernels/flat_adamw.py``)."""
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, 1e-2

    def __init__(self, cfg, base_lr: float):
        self.max_norm = (float(cfg.grad_max_norm) if cfg.use_clip_grad_norm
                         else None)
        self.schedule = cosine_warm_restarts(base_lr)

    def init(self, flat: torch.Tensor) -> OptState:
        return OptState(0, torch.zeros_like(flat), torch.zeros_like(flat), 0)

    def scalars(self, state: OptState, tau: float = 0.0) -> StepScalars:
        """Bias corrections at ``count + 1`` in double (rounded to the
        parameter dtype where they are used, as optax's ``astype``), and
        ``-lr`` at the schedule's count before its increment."""
        c = state.count + 1
        return StepScalars(self.max_norm, self.b1, self.b2, self.eps, self.wd,
                           1 - self.b1 ** c, 1 - self.b2 ** c,
                           -self.schedule(state.sched_count), tau)

    def update(self, flat: torch.Tensor, grad: torch.Tensor,
               state: OptState, target: Optional[torch.Tensor] = None,
               tau: float = 0.0, owner=None) -> OptState:
        """One step on ``flat`` in place (and Polyak into ``target``, in
        place, when given).  ``owner``: the module bound to ``flat``, whose
        ``param_version`` is bumped after the write."""
        flat_adamw(flat, grad, state.mu, state.nu, self.scalars(state, tau),
                   target)
        if owner is not None:
            owner.bump_version()
        return OptState(state.count + 1, state.mu, state.nu,
                        state.sched_count + 1)


def make_optimizer(cfg, base_lr: float) -> FlatAdamW:
    return FlatAdamW(cfg, base_lr)


def flat_polyak(target: torch.Tensor, flat_new: torch.Tensor,
                tau: float) -> torch.Tensor:
    """``tau * new + (1 - tau) * target`` on the flat vectors (the plain
    form; the training path does it inside K6)."""
    return tau * flat_new + (1.0 - tau) * target


def mse(a, b):
    return torch.mean((a - b) ** 2)


def spectral_widths(layout: FlatLayout) -> List[int]:
    """Input widths of the regularized weights, in ``spectral_weights``
    order: the start vectors' sizes."""
    shapes = dict(zip(layout.names, layout.shapes))
    ws, _ = spectral_weights({n: torch.empty(s, device="meta")
                              for n, s in shapes.items()})
    return [int(w.shape[1]) for w in ws]


def spectral_penalty(views: Dict[str, torch.Tensor], starts):
    """The spectral-norm regularizer over a network's parameter views, from
    the power iterations' start vectors ``starts``."""
    ws, extras = spectral_weights(views)
    return regularizers.spectral_norm_regularization(ws, starts, extras)


class FlatAgent:
    """What the TD3, SAC and PPO agents share: the per-agent
    configuration, the acting and critic modules (``models(generator) ->
    (actor, critic)``, made on the CPU, moved to the device and bound to a
    state's flat vectors), their flat layouts, optimizers and spectral
    widths, and the twin critic on parameter views (PPO's ``PPOAgent``
    overrides ``critic_apply`` with its single V network).

    ``equivariant`` (``cfg.use_equiv``): EMLP networks, whose blocks run
    through K3/K4 and whose weights carry the spectral-norm penalty; or
    plain MLPs, which carry no penalty in any learner (JAX's ``ModelDefs``
    leaves ``*_spectral`` None for them, ``td3.py:256``, ``:311``), so their
    spectral widths are empty and no start vectors are drawn.

    ``is_ctde`` (MODUL with ``module_training="CTDE"``): the critic is
    built over every agent's obs (and, for a Q critic, every agent's
    action), ``sum(obs_dim_n)`` and ``sum(action_dim_n)`` wide (JAX
    ``td3.py:116-119``, ``ppo.py:82``); the learners feed it the joint
    batch."""

    def __init__(self, cfg: Config, agent_id: int, device, dtype, models):
        self.cfg, self.agent_id, self.dtype = cfg, agent_id, dtype
        self.is_ctde = cfg.is_ctde
        self.device = resolve_device(device)
        self.obs_dim = cfg.obs_dim_n[agent_id]
        self.action_dim = cfg.action_dim_n[agent_id]
        self._models = models
        actor, critic = models(torch.Generator().manual_seed(0))
        self.actor_net = actor.to(self.device)
        self.critic_net = critic.to(self.device)
        self.actor_layout = flat_layout(self.actor_net)
        self.critic_layout = flat_layout(self.critic_net)
        self.actor_tx = make_optimizer(cfg, cfg.lr_a[agent_id])
        self.critic_tx = make_optimizer(cfg, cfg.lr_c[agent_id])
        self.equivariant = bool(cfg.use_equiv)
        self.critic_widths = (spectral_widths(self.critic_layout)
                              if self.equivariant else [])
        self.actor_widths = (spectral_widths(self.actor_layout)
                             if self.equivariant else [])
        self._bound: Optional[torch.Tensor] = None

    def fresh_flat(self, generator: Optional[torch.Generator] = None):
        """The actor's and critic's flat vectors of freshly seeded networks
        (flax's initializers' distributions, not its bits)."""
        actor, critic = self._models(generator)
        with torch.no_grad():
            a = self.actor_layout.ravel(dict(actor.named_parameters()))
            c = self.critic_layout.ravel(dict(critic.named_parameters()))
        return a.to(self.device), c.to(self.device)

    def own(self, t, like=None, dtype=None) -> torch.Tensor:
        """A contiguous copy of ``t`` (``like`` when ``t`` is None) on the
        agent's device, in ``dtype`` (default the agent's)."""
        return (like if t is None else t).detach().to(
            self.device, dtype or self.dtype).clone().contiguous()

    def bind(self, state) -> None:
        """Make the acting and critic modules views of ``state``'s vectors."""
        bind_flat(self.actor_net, state.actor)
        bind_flat(self.critic_net, state.critic)
        self._bound = state.actor

    def bound_actor(self, state):
        """The acting module, bound to ``state``'s actor vector."""
        if self._bound is not state.actor:
            self.bind(state)
        return self.actor_net

    def critic_apply(self, views: Dict[str, torch.Tensor], obs, act):
        """Both Qs on the parameter ``views`` and ``concat(obs, act)``."""
        return self.critic_apply_sa(views, torch.cat([obs, act], dim=-1))

    def critic_apply_sa(self, views: Dict[str, torch.Tensor], sa):
        """Both Qs on the parameter ``views`` and the critic input ``sa =
        concat(obs, act)`` (a sampled operand, ``algos/replay.py``): the
        EMLP twin's blocks through K3/K4, or the MLP twin as torch ops."""
        if not self.equivariant:
            return mlp.critic_twin_sa(views, sa)
        return (emlp_apply(self.critic_net.network1, views, "network1.", sa),
                emlp_apply(self.critic_net.network2, views, "network2.", sa))
