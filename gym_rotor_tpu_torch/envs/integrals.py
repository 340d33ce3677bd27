"""Trapezoidal integral and finite-difference helpers (port of
``gym_rotor_tpu/envs/integrals.py``).

The state is an explicit (value, memory) pair.  The env core inlines the
same update (``quad.norm_error_state``); these standalone versions are for
controllers and analysis code.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class IntegralState(NamedTuple):
    """(error, integrand): ``IntegralError``/``IntegralErrorVec3``, scalars
    and vectors alike."""
    error: torch.Tensor
    integrand: torch.Tensor

    @classmethod
    def zero(cls, shape=(), dtype=torch.float32, device=None):
        z = torch.zeros(shape, dtype=dtype, device=device)
        return cls(error=z, integrand=z.clone())


def integrate(state: IntegralState, current_integrand, dt) -> IntegralState:
    """error += (integrand + current) * dt / 2 (``integrals.py:28-32``)."""
    error = state.error + ((state.integrand + current_integrand) * dt) / 2.0
    return IntegralState(error=error, integrand=current_integrand)


class DerivativeState(NamedTuple):
    """(y_dot, previous_y): ``TimeDerivativeVec3``."""
    y_dot: torch.Tensor
    previous_y: torch.Tensor

    @classmethod
    def zero(cls, shape=(3,), dtype=torch.float32, device=None):
        z = torch.zeros(shape, dtype=dtype, device=device)
        return cls(y_dot=z, previous_y=z.clone())


def derivative(state: DerivativeState, current_y, dt) -> DerivativeState:
    """Backward difference y_dot = (y - y_prev) / dt (``integrals.py:49-53``)."""
    return DerivativeState(y_dot=(current_y - state.previous_y) / dt,
                           previous_y=current_y)
