"""The squashed-Gaussian policy head of SAC (port of the SAC part of
``gym_rotor_tpu/models/mlp.py``: ``LOG_SIG_MAX``/``LOG_SIG_MIN``, ``EPS``
and ``sac_sample_with_noise``).  This is the plain version; the training
path runs the sample and its log-prob through K10
(``kernels/sac_sample.py``) and the acting path through K9
(``kernels/emlp_actor.py``).  ``sac_sample`` (the draw from a key) has
no counterpart: the port makes its draws up front (``envs/draws.py``) and
passes them as ``noise``.  The MLP actor classes are not ported yet.
"""
from __future__ import annotations

import math

import torch

LOG_SIG_MAX = 2.0
LOG_SIG_MIN = -20.0
EPS = 1e-6
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def sac_sample_with_noise(mean, log_std, noise):
    """Reparameterized tanh-squashed sample and its corrected log-prob from
    the N(0, 1) draw ``noise`` (``mlp.py:129-143``, the expression as JAX
    writes it).  Returns ``(action, log_prob (..., 1), tanh(mean))``."""
    std = torch.exp(log_std)
    x_t = mean + std * noise
    action = torch.tanh(x_t)
    log_prob = -0.5 * ((x_t - mean) / std) ** 2 - log_std - HALF_LOG_2PI
    log_prob = log_prob - torch.log((1.0 - action ** 2) + EPS)
    log_prob = torch.sum(log_prob, dim=-1, keepdim=True)
    return action, log_prob, torch.tanh(mean)

