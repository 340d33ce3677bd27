"""The Gaussian policy heads of SAC and PPO (port of those parts of
``gym_rotor_tpu/models/mlp.py``: ``LOG_SIG_MAX``/``LOG_SIG_MIN``, ``EPS``,
``sac_sample_with_noise``, ``gaussian_logprob`` and ``gaussian_entropy``).
These are the plain versions; the training paths run SAC's sample through
K10 (``kernels/sac_sample.py``) and PPO's surrogate through K13
(``kernels/ppo_loss.py``), the acting paths through K9 and K11
(``kernels/emlp_actor.py``).  ``sac_sample`` (the draw from a key) has no
counterpart: the port makes its draws up front (``envs/draws.py``) and
passes them as ``noise``.  The MLP actor classes are not ported yet.
"""
from __future__ import annotations

import math

import torch

LOG_SIG_MAX = 2.0
LOG_SIG_MIN = -20.0
EPS = 1e-6
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
HALF_LOG_2PIE = 0.5 * math.log(2.0 * math.pi * math.e)


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


def gaussian_logprob(mean, log_std, action):
    """Per-dimension log-density of ``action`` (``mlp.py:173-178``)."""
    std = torch.exp(log_std)
    return -0.5 * ((action - mean) / std) ** 2 - log_std - HALF_LOG_2PI


def gaussian_entropy(log_std):
    """Per-dimension entropy (``mlp.py:181-182``)."""
    return log_std + HALF_LOG_2PIE

