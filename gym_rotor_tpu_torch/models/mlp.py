"""Plain MLP networks and the Gaussian policy heads (port of
``gym_rotor_tpu/models/mlp.py``).

TD3's networks: ``ActorTD3`` (Dense -> relu -> Dense -> relu -> Dense ->
tanh), ``CriticTwin`` (two such Q nets over ``concat(obs, act)``, with
``q1``), ``CriticSingle`` and ``critic_twin_split``, with flax's names
(``Dense_0..2``, ``q1_fc1..q2_fc3``, ``fc1..3``) and flax's ``(in, out)``
kernel layout (``Dense``), so a network's flat vector is in
``ravel_pytree``'s order and JAX's AdamW moments carry across.  JAX runs
them as plain XLA dots with a relu/tanh epilogue, outside any kernel; here
each layer is ``torch.nn.functional.linear`` (cuBLAS on the card, in full
float32: the port leaves ``torch.backends.cuda.matmul.allow_tf32`` at its
default, False).  The acting forward reads the parameters the module is
bound to, which are views of the learner's flat vector (``bind_flat``): no
copy, so nothing to re-key when the optimizer writes them in place.  The
training path applies the same functions to a loss's parameter views
(``actor_td3``, ``q_net``).

SAC's and PPO's networks: ``ActorSAC`` (Xavier-initialised ``Dense_0``,
``Dense_1``, the ``mean`` head and the ``log_std`` Dense, clipped to
[LOG_SIG_MIN, LOG_SIG_MAX]), ``ActorPPO`` (``Dense_0``, ``Dense_1``, a
``tanh`` ``mean`` head whose kernel is scaled by 0.1 at init, and the free
``log_std`` (1, act)) and ``VCritic`` (``Dense_0..2`` with ``tanh``), with
the functions ``actor_sac``, ``actor_ppo`` and ``v_critic`` on parameter
views.  Under CTDE the critics take the joint input: ``CriticTwin`` over
all agents' obs and actions, ``VCritic`` over all agents' obs.  Acting on
the card, ``ActorSAC``'s and ``ActorPPO``'s whole acting forwards are one
launch each, with the SAC head (``kernels/mlp_sac_actor.py``) or K11's
head (``kernels/mlp_ppo_actor.py``) as the epilogue; each also has a
deterministic eval head (``tanh(mean)``; ``clip(tanh(mean))`` and zero
log-probs).

The Gaussian heads' plain versions: ``LOG_SIG_MAX``/``LOG_SIG_MIN``,
``EPS``, ``sac_sample_with_noise``, ``gaussian_logprob`` and
``gaussian_entropy``; the training paths run SAC's heads and sample through
the fused head kernel (K10, ``kernels/sac_sample.py``, on ``sac_trunk``'s
output and ``sac_heads``) and PPO's surrogate through K13
(``kernels/ppo_loss.py``), the EMLP acting paths through K9 and K11.
``sac_sample`` (the draw from a key) has no counterpart: the port makes
its draws up front (``envs/draws.py``) and passes them as ``noise``.

Every network carries ``param_version`` (``Versioned``), an explicit
counter of in-place parameter writes: the flat optimizer bumps it after
each launch and the EMLP acting kernel's fold cache keys on it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

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



class Versioned(nn.Module):
    """``param_version`` counts in-place parameter writes; moving or loading
    the module counts as one too."""

    def __init__(self):
        super().__init__()
        self.param_version = 0

    def bump_version(self):
        self.param_version += 1

    def _apply(self, fn, *args, **kwargs):
        self.param_version += 1
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        out = super().load_state_dict(*args, **kwargs)
        self.param_version += 1
        return out


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (nin, nout), ``bias`` (nout,), LeCun
    normal kernel (truncated at two standard deviations, flax's default),
    scaled by ``scale``, or with ``xavier`` flax's ``xavier_uniform``; zero
    bias."""

    def __init__(self, nin: int, nout: int, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None,
                 xavier: bool = False, scale: float = 1.0):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(nin, nout, device=device,
                                               dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(nout, device=device, dtype=dtype))
        with torch.no_grad():
            if xavier:
                limit = math.sqrt(6.0 / (nin + nout))
                self.kernel.uniform_(-limit, limit, generator=generator)
            else:
                std = math.sqrt(1.0 / nin) / 0.87962566103423978
                nn.init.trunc_normal_(self.kernel, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
            self.kernel.mul_(scale)

    def forward(self, x):
        return F.linear(x, self.kernel.t(), self.bias)


Params = Dict[str, torch.Tensor]


def dense(params: Params, prefix: str, x):
    """``x @ kernel + bias`` with ``params[prefix + "kernel"]`` (nin, nout)
    and ``params[prefix + "bias"]``: one ``F.linear``."""
    return F.linear(x, params[prefix + "kernel"].t(), params[prefix + "bias"])


def actor_td3(params: Params, obs):
    """``ActorTD3`` on ``params`` (``Dense_0..2``; mlp.py:33-42)."""
    x = torch.relu(dense(params, "Dense_0.", obs))
    x = torch.relu(dense(params, "Dense_1.", x))
    return torch.tanh(dense(params, "Dense_2.", x))


def sac_trunk(params: Params, obs):
    """``ActorSAC``'s two relu layers: the heads' input."""
    x = torch.relu(dense(params, "Dense_0.", obs))
    return torch.relu(dense(params, "Dense_1.", x))


def sac_heads(params: Params):
    """``ActorSAC``'s heads as the fused head kernel takes them: the
    ``mean`` and ``log_std`` Dense kernels (H, act) and biases."""
    return (params["mean.kernel"], params["mean.bias"],
            params["log_std.kernel"], params["log_std.bias"])


def actor_sac(params: Params, obs):
    """``ActorSAC`` on ``params``: ``(mean, log_std)``, ``log_std`` clipped
    to [LOG_SIG_MIN, LOG_SIG_MAX] (mlp.py:107-119)."""
    x = sac_trunk(params, obs)
    return (dense(params, "mean.", x),
            torch.clamp(dense(params, "log_std.", x), LOG_SIG_MIN,
                        LOG_SIG_MAX))


def actor_ppo_pre(params: Params, obs):
    """``ActorPPO``'s mean head before its ``tanh`` (mlp.py:157-165)."""
    x = torch.relu(dense(params, "Dense_0.", obs))
    x = torch.relu(dense(params, "Dense_1.", x))
    return dense(params, "mean.", x)


def actor_ppo(params: Params, obs):
    """``ActorPPO`` on ``params``: ``(tanh mean, log_std)``, the free
    ``log_std`` (1, act) broadcast to the mean's shape (mlp.py:146-171)."""
    mean = torch.tanh(actor_ppo_pre(params, obs))
    return mean, params["log_std"].expand_as(mean)


def v_critic(params: Params, obs):
    """``VCritic`` on ``params`` (mlp.py:185-194)."""
    v = torch.tanh(dense(params, "Dense_0.", obs))
    v = torch.tanh(dense(params, "Dense_1.", v))
    return dense(params, "Dense_2.", v)


def q_net_sa(params: Params, prefix: str, sa):
    """One Q net of ``CriticTwin`` (``prefix`` ``"q1_"``/``"q2_"``) or
    ``CriticSingle`` (``""``) on ``params`` and ``sa = concat(obs, act)``
    (mlp.py:55-84)."""
    q = torch.relu(dense(params, f"{prefix}fc1.", sa))
    q = torch.relu(dense(params, f"{prefix}fc2.", q))
    return dense(params, f"{prefix}fc3.", q)


def q_net(params: Params, prefix: str, obs, act):
    """``q_net_sa`` on ``concat(obs, act)``."""
    return q_net_sa(params, prefix, torch.cat([obs, act], dim=-1))


def critic_twin_sa(params: Params, sa):
    """``CriticTwin`` on ``params`` and ``sa = concat(obs, act)``: ``(q1,
    q2)``."""
    return q_net_sa(params, "q1_", sa), q_net_sa(params, "q2_", sa)


def critic_twin(params: Params, obs, act):
    """``CriticTwin`` on ``params``: ``(q1, q2)``."""
    return critic_twin_sa(params, torch.cat([obs, act], dim=-1))


def critic_twin_split(params: Params):
    """Twin parameters (``q1_fc1.kernel`` ...) -> (net1, net2) parameters
    named as ``CriticSingle``'s (``fc1.kernel`` ...): a pure relabeling, as
    ``mlp.py:87-96``."""
    out = ({}, {})
    for name, t in params.items():
        head, _, rest = name.partition("_")
        out[{"q1": 0, "q2": 1}[head]][rest] = t
    return out


class _DenseNet(Versioned):
    """A network of flax ``Dense`` layers; ``params()`` maps its dotted
    names to its parameters, the form the functions above take."""

    def _layers(self, names, widths, kw):
        """Layers ``names[k]`` from ``widths[k]`` to ``widths[k + 1]``."""
        for name, a, b in zip(names, widths, widths[1:]):
            self.add_module(name, Dense(a, b, **kw))

    def params(self) -> Params:
        return dict(self.named_parameters())


class ActorTD3(_DenseNet):
    """Deterministic tanh MLP actor (mlp.py:33-42).  ``forward(obs, out)``
    is the acting path: the action, written into ``out`` (e.g. a column
    slice of the joint action) when given."""

    def __init__(self, obs_dim: int, hidden_dim: int, action_dim: int,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._layers(("Dense_0", "Dense_1", "Dense_2"),
                     (obs_dim, hidden_dim, hidden_dim, action_dim),
                     dict(device=device, dtype=dtype, generator=generator))
        self.action_dim = action_dim

    def forward(self, obs, out: Optional[torch.Tensor] = None):
        a = actor_td3(self.params(), obs)
        if out is None:
            return a
        out.copy_(a)
        return out


class CriticTwin(_DenseNet):
    """Twin Q MLPs over ``concat(obs, act)`` (mlp.py:45-69), ``q1_fc1..3``
    and ``q2_fc1..3``."""

    def __init__(self, in_dim: int, hidden_dim: int, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        for q in ("q1", "q2"):
            self._layers((f"{q}_fc1", f"{q}_fc2", f"{q}_fc3"),
                         (in_dim, hidden_dim, hidden_dim, 1), kw)

    def forward(self, obs, act):
        return critic_twin(self.params(), obs, act)

    def q1(self, obs, act):
        return q_net(self.params(), "q1_", obs, act)


class CriticSingle(_DenseNet):
    """One Q MLP with ``CriticTwin``'s architecture, ``fc1..3``, applied to
    a ``critic_twin_split`` half (mlp.py:72-84)."""

    def __init__(self, in_dim: int, hidden_dim: int, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._layers(("fc1", "fc2", "fc3"), (in_dim, hidden_dim, hidden_dim, 1),
                     dict(device=device, dtype=dtype, generator=generator))

    def forward(self, obs, act):
        return q_net(self.params(), "", obs, act)


class ActorSAC(_DenseNet):
    """Squashed-Gaussian MLP actor (mlp.py:107-119), flax's names
    (``Dense_0``, ``Dense_1``, ``mean``, ``log_std``; flat order ``Dense_0``,
    ``Dense_1``, ``log_std``, ``mean``) and Xavier-uniform kernels.
    ``dist`` is ``(mean, log_std)``.  ``forward`` is the acting sample
    ``tanh(mean + exp(log_std) noise)``, or ``tanh(mean)`` without
    ``noise`` (eval): one launch of the fused actor
    (``kernels/mlp_sac_actor.py``; its plain twin, ``dist`` and the plain
    sample, on CPU tensors), written into ``out`` when given."""

    def __init__(self, obs_dim: int, hidden_dim: int, action_dim: int,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator,
                  xavier=True)
        self._layers(("Dense_0", "Dense_1", "mean"),
                     (obs_dim, hidden_dim, hidden_dim, action_dim), kw)
        self.add_module("log_std", Dense(hidden_dim, action_dim, **kw))
        self.action_dim = action_dim

    def dist(self, obs):
        return actor_sac(self.params(), obs)

    def forward(self, obs, noise: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None):
        from ..kernels.mlp_sac_actor import mlp_sac_actor
        return mlp_sac_actor(self, obs, noise, out)


class ActorPPO(_DenseNet):
    """Gaussian MLP actor with a ``tanh`` mean and a learnable
    state-independent ``log_std`` (1, act) (mlp.py:146-171): flax's names
    (flat order ``Dense_0``, ``Dense_1``, ``log_std``, ``mean``), the mean
    head's LeCun kernel scaled by 0.1 and ``log_std`` 0 at init.  ``dist``
    is ``(mean, log_std)``.  ``forward`` is the acting draw ``(clip(mean +
    exp(log_std) noise), per-dim log-prob)``, or ``(clip(mean), zeros)``
    without ``noise`` (eval): one launch of the fused actor
    (``kernels/mlp_ppo_actor.py``; its plain twin, the ``F.linear`` chain
    and K11's head, on CPU tensors), written into ``out`` and ``logp``
    when given."""

    def __init__(self, obs_dim: int, hidden_dim: int, action_dim: int,
                 max_action: float = 1.0, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self._layers(("Dense_0", "Dense_1"),
                     (obs_dim, hidden_dim, hidden_dim), kw)
        self.add_module("mean", Dense(hidden_dim, action_dim, scale=0.1,
                                      **kw))
        self.log_std = nn.Parameter(torch.zeros((1, action_dim),
                                                device=device, dtype=dtype))
        self.action_dim = action_dim
        self.max_action = float(max_action)

    def dist(self, obs):
        return actor_ppo(self.params(), obs)

    def forward(self, obs, noise: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None,
                logp: Optional[torch.Tensor] = None):
        from ..kernels.mlp_ppo_actor import mlp_ppo_actor
        return mlp_ppo_actor(self, obs, noise, out, logp)


class VCritic(_DenseNet):
    """V(s) MLP critic with ``tanh`` activations (mlp.py:185-194),
    ``Dense_0..2``; under CTDE over all agents' obs."""

    def __init__(self, in_dim: int, hidden_dim: int, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._layers(("Dense_0", "Dense_1", "Dense_2"),
                     (in_dim, hidden_dim, hidden_dim, 1),
                     dict(device=device, dtype=dtype, generator=generator))

    def forward(self, obs):
        return v_critic(self.params(), obs)
