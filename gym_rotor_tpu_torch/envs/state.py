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


def pack_state(x, v, R, W):
    """(x, v, R, W) -> the 18-vector with R column-major in slots 6:15
    (``state.py:61-68``)."""
    R_vec = R.transpose(-1, -2).reshape(R.shape[:-2] + (9,))
    return torch.cat([x, v, R_vec, W], dim=-1)


def unpack_state(s18):
    """The 18-vector -> (x, v, R, W); inverse of ``pack_state``
    (``state.py:71-77``)."""
    R = s18[..., 6:15].reshape(s18.shape[:-1] + (3, 3)).transpose(-1, -2)
    return s18[..., 0:3], s18[..., 3:6], R, s18[..., 15:18]
