"""Injected random draws.

The JAX package carries threefry keys in its state (``EnvState.key``,
``TrajState.key``) and splits them inside the tick; torch cannot reproduce
those bits.  The port carries no keys: each tick takes a ``(B, N_DRAWS)``
tensor of U[0, 1) base draws, and every random site maps its slot into its
range the way ``jax.random.uniform`` does,
``max(lo, u * (hi - lo) + lo)`` with ``lo``/``hi`` rounded to the dtype
first.  The kernel and the plain version read the same tensor, so they are
exactly comparable on the card, and the CPU tests feed JAX's own draws.

Slot layout (one row per env, every slot consumed every tick, as the dense
JAX tick consumes every key):
"""
from __future__ import annotations

from typing import Optional

import torch

THETA = 0            # mode-0 heading offset for the current machine
#                      (trajectory._mode_idle, trajectory.py:137-141)
UDM = slice(1, 7)    # params.randomize: m, d, J1, J3, c_tf, c_tw
AT_ORIGIN = 7        # quad._init_ranges 20%-at-origin branch (quad.py:401-402)
RESET = slice(8, 20)  # quad.reset_state's 12 uniforms (quad.py:431)
FRESH_THETA = 20     # mode-0 heading offset of the fresh machine
N_DRAWS = 21


def uniform_in(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Map base draws ``u`` in [0, 1) to [lo, hi) exactly as
    ``jax.random._uniform`` does in ``u``'s dtype."""
    lo_t = torch.tensor(lo, dtype=u.dtype, device=u.device)
    hi_t = torch.tensor(hi, dtype=u.dtype, device=u.device)
    return torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)


def draw_uniforms(batch: int, generator: Optional[torch.Generator],
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """One tick's base draws, made on the device from an explicit
    generator (in-kernel Philox is a later optimization)."""
    return torch.rand((batch, N_DRAWS), generator=generator, dtype=dtype,
                      device=device)
