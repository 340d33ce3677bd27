"""Learner plumbing (port of ``gym_rotor_tpu/algos/common.py``): the
cosine warm-restart schedule, the flat optimizer chain (clip to the global
norm, then AdamW, with optax's semantics), flat Polyak averaging and mse.

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
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.flat_adamw import StepScalars, flat_adamw


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
