"""Actor-loss regularizers (port of ``gym_rotor_tpu/algos/regularizers.py``):
CAPS action smoothness and the spectral-norm penalty.

The power iteration of ``spectral_norm_regularization`` is K7
(``kernels/spectral.py``: one launch per network on the card, its plain twin
on the CPU); it returns the detached iterate ``v``, as JAX
``stop_gradient``s it, so ``sigma = |W v|``, its gradient ``2 (W v) vᵀ`` and
the Frobenius terms of the extras are torch autograd.  ``caps_terms`` is
three means of squares in torch.  The random start vectors and the CAPS
perturbation are injected (``envs/draws.py``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..envs import params as params_lib
from ..kernels.spectral import ITERS, spectral_iterate


def hover_action_scalar() -> float:
    """Normalized hover total-thrust action at nominal parameters
    (regularizers.py:22-39)."""
    hover = params_lib.M_NOMINAL * params_lib.G_STD / 4.0
    lo = params_lib.MIN_FORCE
    hi = params_lib.C_TW_NOMINAL * hover
    return float((hover - lo) / (hi - lo) * 2.0 - 1.0)


def nominal_action(framework: str, agent_id: int, batch: int,
                   action_dim: int, dtype=torch.float32, device=None):
    """Per-framework hover-nominal action (regularizers.py:42-49)."""
    a = torch.zeros(batch, action_dim, dtype=dtype, device=device)
    if framework == "MONO" or (framework == "MODUL" and agent_id == 0):
        a[:, 0] = hover_action_scalar()
    return a


def caps_noise(eps: torch.Tensor) -> torch.Tensor:
    """The spatial-smoothness perturbation from its N(0, 1) draw ``eps``
    (1, obs dim): 0.05 * eps, broadcast over the batch."""
    return 0.05 * eps


def caps_terms(cfg, agent_id, act, act_next, act_pert):
    """lam_T L_T + lam_S L_S + lam_M L_M from clipped actions
    (regularizers.py:58-69)."""
    loss_T = torch.mean((act - act_next) ** 2)
    loss_S = torch.mean((act - act_pert) ** 2)
    nominal = nominal_action(cfg.framework, agent_id, act.shape[0],
                             act.shape[-1], act.dtype, act.device)
    loss_M = torch.mean((act - nominal) ** 2)
    return cfg.lam_T * loss_T + cfg.lam_S * loss_S + cfg.lam_M * loss_M


def stack_padded(weights: Sequence[torch.Tensor],
                 starts: Sequence[torch.Tensor]):
    """The zero-padded ``(K, mo, mi)`` stack of ``weights`` and ``(K, mi)``
    of their start vectors (regularizers.py:122-132)."""
    mo = max(int(W.shape[0]) for W in weights)
    mi = max(int(W.shape[1]) for W in weights)
    Ws = torch.stack([F.pad(W, (0, mi - W.shape[1], 0, mo - W.shape[0]))
                      for W in weights])
    x = torch.stack([F.pad(s.to(Ws.dtype), (0, mi - s.shape[0]))
                     for s in starts])
    return Ws, x.contiguous()


def approx_spectral_norm(W: torch.Tensor, start: torch.Tensor,
                         iters: int = ITERS) -> torch.Tensor:
    """|W v| after ``iters`` power steps from ``start`` (regularizers.py:85);
    differentiable in W through the final matvec only."""
    Ws, x = stack_padded([W], [start])
    v = spectral_iterate(Ws.detach().contiguous(), x, iters)
    return torch.linalg.vector_norm(Ws[0] @ v[0])


def spectral_norm_regularization(weights: Sequence[torch.Tensor],
                                 starts: Sequence[torch.Tensor],
                                 extras: Sequence[torch.Tensor] = (),
                                 iters: int = ITERS):
    """Sum of squared spectral norms of ``weights`` (zero-padded to one
    (K, mo, mi) stack, one start vector each) plus the squared Frobenius
    norms of ``extras`` (regularizers.py:102-158)."""
    total = 0.0
    if weights:
        Ws, x = stack_padded(weights, starts)
        v = spectral_iterate(Ws.detach().contiguous(), x, iters)
        sigma = torch.linalg.vector_norm(torch.einsum("kij,kj->ki", Ws, v),
                                         dim=-1)
        total = total + torch.sum(sigma * sigma)
    for e in extras:
        total = total + torch.sum(e * e)
    return total
