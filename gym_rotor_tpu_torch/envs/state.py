"""Env state containers (port of ``gym_rotor_tpu/envs/state.py``).

Same fields as the JAX pytrees minus the PRNG ``key``: the port takes its
random draws as an injected tensor (``envs/draws.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .params import QuadParams


@dataclass
class Goal:
    xd: torch.Tensor
    vd: torch.Tensor
    b1d: torch.Tensor
    b1d_dot: torch.Tensor
    Wd: torch.Tensor

    @classmethod
    def default(cls, batch=(), dtype=torch.float32, device=None):
        z = torch.zeros(tuple(batch) + (3,), dtype=dtype, device=device)
        b1d = torch.zeros_like(z)
        b1d[..., 0] = 1.0
        return cls(xd=z, vd=z.clone(), b1d=b1d, b1d_dot=z.clone(), Wd=z.clone())


@dataclass
class EnvState:
    x: torch.Tensor
    v: torch.Tensor
    R: torch.Tensor
    W: torch.Tensor
    eIx: torch.Tensor
    eIx_integrand: torch.Tensor
    eIb1: torch.Tensor
    eIb1_integrand: torch.Tensor
    f_total: torch.Tensor
    M: torch.Tensor
    goal: Goal
    params: QuadParams
    t: torch.Tensor           # int32 step count within the episode
