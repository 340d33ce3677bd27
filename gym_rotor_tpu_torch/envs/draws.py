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

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

THETA = 0            # mode-0 heading offset for the current machine
#                      (trajectory._mode_idle, trajectory.py:137-141)
UDM = slice(1, 7)    # params.randomize: m, d, J1, J3, c_tf, c_tw
AT_ORIGIN = 7        # quad._init_ranges 20%-at-origin branch (quad.py:401-402)
RESET = slice(8, 20)  # quad.reset_state's 12 uniforms (quad.py:431)
FRESH_THETA = 20     # mode-0 heading offset of the fresh machine
HOVER_T = 21         # mode-1 settle time U(2, 5) of the current machine
HOVER_W = 22         # mode-1 yaw rate U(+-0.15 pi) of the current machine
#                      (trajectory._mode_hover, trajectory.py:161-163)
FRESH_HOVER_T = 23   # the same two of the fresh machine
FRESH_HOVER_W = 24
N_DRAWS = 25


class TrajDraws(NamedTuple):
    """One trajectory machine's base draws for a tick: the mode-0 heading
    offset and the mode-1 settle time and yaw rate.  Every slot is consumed
    every tick whatever the mode, as the JAX machine's key is."""
    theta: torch.Tensor
    hover_t: torch.Tensor
    hover_w: torch.Tensor


def traj_draws(u: torch.Tensor, fresh: bool = False) -> TrajDraws:
    """The current (or, ``fresh``, the auto-reset's new) machine's slots
    of the base draws ``u`` ``(..., N_DRAWS)``."""
    if fresh:
        return TrajDraws(u[..., FRESH_THETA], u[..., FRESH_HOVER_T],
                         u[..., FRESH_HOVER_W])
    return TrajDraws(u[..., THETA], u[..., HOVER_T], u[..., HOVER_W])


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


# ---------------------------------------------------------------------------
# The training path's random sites.  Each takes its draws as tensors; the
# ``make_*`` helpers draw them from an explicit generator, the CPU tests
# hand in JAX's own (rebuilt from its key chain).
# ---------------------------------------------------------------------------
class TickDraws(NamedTuple):
    """One superstep tick: ``env`` (B, N_DRAWS) U[0, 1) for the tick, and
    ``policy``: on a warm tick U[0, 1) base draws (B, sum act dims) of the
    uniform actions (``train_step.py:120``, mapped to [-1, 1) by
    ``uniform_in``); on a train tick one N(0, 1) (B, act_i) per agent, the
    exploration noise of ``choose_action_f`` (``td3.py:149``), SAC's
    acting sample (``sac.py:114``) or PPO's acting draw (``ppo.py:113``)."""
    env: torch.Tensor
    policy: Union[torch.Tensor, Tuple[torch.Tensor, ...]]


class AgentDraws(NamedTuple):
    """One agent's update: the target-smoothing N(0, 1) (batch, act)
    (``td3.py:227``), or under CTDE a tuple of one (batch, act_j) per agent
    ``j``, every agent's target action smoothed (``td3.py:209-221``, a
    ``split`` chain over the agents); the CAPS N(0, 1) (1, obs)
    (``regularizers.py:55``, scaled by 0.05 there), and one N(0, 1) start
    vector per regularized weight, critic then actor, in
    ``spectral_weights`` order (``regularizers.py:129``, one
    ``fold_in(key, i)`` each)."""
    target_noise: Union[torch.Tensor, Tuple[torch.Tensor, ...]]
    caps_eps: torch.Tensor
    critic_starts: Tuple[torch.Tensor, ...]
    actor_starts: Tuple[torch.Tensor, ...]


class SACAgentDraws(NamedTuple):
    """One agent's SAC update (``sac.py:146``, ``ks = split(key, 6)``): the
    target sample's N(0, 1) (batch, act) on ``next_obs`` (``ks[1]``), the
    CAPS N(0, 1) (1, obs) (``ks[3]``, scaled by 0.05), the policy sample's
    ``n_pi`` and the three CAPS samples' shared ``n_caps``, N(0, 1) (batch,
    act) each (``ks[4]``, ``ks[5]``, ``sac.py:239-240``), and the spectral
    start vectors, critic then actor, in ``spectral_weights`` order (both
    sets from ``ks[2]`` in JAX, one ``fold_in(ks[2], i)`` each).

    Under CTDE two more, one (batch, act_j) per agent ``j`` each:
    ``next_joint``, the sample of every agent's actor on its ``next_obs``
    for the joint target action (``sac.py:153-160``, a ``split`` chain
    from ``ks[0]``), and ``pi_joint``, the sample of every agent's actor on
    its ``obs`` for the joint action of the actor loss (``sac.py:212-220``,
    a chain from ``ks[3]``); there ``n_pi`` is the agent's own log-prob
    sample (``ks[4]``) and ``n_caps`` the one shared by the three CAPS
    samples (``ks[5]``, ``caps_regularization``'s ``act_fn``)."""
    next_noise: torch.Tensor
    caps_eps: torch.Tensor
    n_pi: torch.Tensor
    n_caps: torch.Tensor
    critic_starts: Tuple[torch.Tensor, ...]
    actor_starts: Tuple[torch.Tensor, ...]
    next_joint: Optional[Tuple[torch.Tensor, ...]] = None
    pi_joint: Optional[Tuple[torch.Tensor, ...]] = None


class UpdateDraws(NamedTuple):
    """One update: the replay indices (batch,) in [0, max(filled, 1))
    (``replay.py:207``) and one ``AgentDraws`` (TD3) or ``SACAgentDraws``
    per agent."""
    idx: torch.Tensor
    agents: Tuple[Union[AgentDraws, SACAgentDraws], ...]


class PPOEpochDraws(NamedTuple):
    """One agent's PPO epoch (``ppo.py:225-228``): the permutation ``perm``
    (T,) of the horizon's ``T = rollout_len * B`` flattened rows, shared by
    the actor's and the critic's minibatches; the CAPS N(0, 1) (1, obs)
    shared by every actor minibatch of the epoch (scaled by 0.05 there);
    and one N(0, 1) start vector per regularized weight, actor then
    critic, in ``spectral_weights`` order, shared by every minibatch.

    JAX's key chain, which the tests rebuild: the superstep's key is
    ``fold_in(key, axis_index)`` then ``split`` into the rollout and update
    keys (``train_step.py:245-246``); ``train_step`` splits one key per
    agent off the update key (``ppo.py:158``); ``_train_one`` splits it into
    ``K_epochs`` epoch keys (``:316``), and each epoch key into ``k_perm``,
    ``k_caps``, ``k_spec`` (``:227``): ``permutation(k_perm, T)``,
    ``normal(k_caps, (1, obs))`` and, for the actor's and the critic's
    weights alike, ``normal(fold_in(k_spec, i), (W.shape[1],))``."""
    perm: torch.Tensor
    caps_eps: torch.Tensor
    actor_starts: Tuple[torch.Tensor, ...]
    critic_starts: Tuple[torch.Tensor, ...]


def make_tick_draws(batch: int, act_dims: Sequence[int], warm: bool,
                    generator: Optional[torch.Generator], device,
                    dtype=torch.float32) -> TickDraws:
    env = draw_uniforms(batch, generator, dtype, device)
    if warm:
        policy = torch.rand((batch, sum(act_dims)), generator=generator,
                            dtype=dtype, device=device)
    else:
        policy = tuple(torch.randn((batch, d), generator=generator,
                                   dtype=dtype, device=device)
                       for d in act_dims)
    return TickDraws(env, policy)


def make_update_draws(batch: int, filled: int, obs_dims: Sequence[int],
                      act_dims: Sequence[int],
                      critic_widths: Sequence[Sequence[int]],
                      actor_widths: Sequence[Sequence[int]],
                      generator: Optional[torch.Generator], device,
                      dtype=torch.float32, ctde: bool = False) -> UpdateDraws:
    """``*_widths[i]``: the input widths (``W.shape[1]``) of agent ``i``'s
    regularized weights, in ``spectral_weights`` order; ``ctde``: each
    agent draws a target-smoothing noise for every agent."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)

    def target(a):
        return (tuple(normal(batch, d) for d in act_dims) if ctde
                else normal(batch, a))
    idx = torch.randint(0, max(filled, 1), (batch,), generator=generator,
                        device=device)
    agents = tuple(
        AgentDraws(target(a), normal(1, o),
                   tuple(normal(w) for w in cw), tuple(normal(w) for w in aw))
        for o, a, cw, aw in zip(obs_dims, act_dims, critic_widths,
                                actor_widths))
    return UpdateDraws(idx, agents)


def make_ppo_epoch_draws(rows: int, k_epochs: int, obs_dims: Sequence[int],
                         actor_widths: Sequence[Sequence[int]],
                         critic_widths: Sequence[Sequence[int]],
                         generator: Optional[torch.Generator], device,
                         dtype=torch.float32
                         ) -> Tuple[Tuple[PPOEpochDraws, ...], ...]:
    """Per agent, ``k_epochs`` ``PPOEpochDraws`` over a horizon of ``rows``
    flattened rows; ``*_widths[i]`` as in ``make_update_draws``."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)
    return tuple(
        tuple(PPOEpochDraws(
            torch.randperm(rows, generator=generator, device=device),
            normal(1, o), tuple(normal(w) for w in aw),
            tuple(normal(w) for w in cw)) for _ in range(k_epochs))
        for o, aw, cw in zip(obs_dims, actor_widths, critic_widths))


def make_sac_update_draws(batch: int, filled: int, obs_dims: Sequence[int],
                          act_dims: Sequence[int],
                          critic_widths: Sequence[Sequence[int]],
                          actor_widths: Sequence[Sequence[int]],
                          generator: Optional[torch.Generator], device,
                          dtype=torch.float32,
                          ctde: bool = False) -> UpdateDraws:
    """``make_update_draws`` for SAC: ``SACAgentDraws`` per agent, with
    ``next_joint`` and ``pi_joint`` under ``ctde``."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)

    def joint():
        return tuple(normal(batch, d) for d in act_dims) if ctde else None
    idx = torch.randint(0, max(filled, 1), (batch,), generator=generator,
                        device=device)
    agents = tuple(
        SACAgentDraws(normal(batch, a), normal(1, o), normal(batch, a),
                      normal(batch, a), tuple(normal(w) for w in cw),
                      tuple(normal(w) for w in aw), joint(), joint())
        for o, a, cw, aw in zip(obs_dims, act_dims, critic_widths,
                                actor_widths))
    return UpdateDraws(idx, agents)
