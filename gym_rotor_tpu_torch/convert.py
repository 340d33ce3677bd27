"""Carry weights, learner state, replay rings and env state across from the
JAX package.

Every function takes numpy arrays (nested dicts, as
``flax.serialization.to_state_dict`` plus ``np.asarray`` gives them), never
JAX objects, so this module imports no JAX.  A network's flat parameter
vector is built in ``ravel_pytree`` order (the dotted flax paths sorted as
path tuples, ``algos/common.py::FlatLayout``), so the JAX flat optimizer
state (``flat_init``'s ``mu``/``nu``) carries across as it is.  The
``*_to_jax`` functions go the other way for the actors (TD3, SAC and PPO,
EMLP and MLP) and any flat vector: the flax tree of numpy arrays, keys in
sorted order, which ``utils/checkpoint.py::save_actor`` writes in flax's
byte layout.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Mapping, Optional

import numpy as np
import torch

from .algos.common import FlatLayout, OptState
from .algos.replay import ReplayState
from .algos.sac import AlphaOptState
from .envs.batch import BatchedEnvState
from .envs.params import QuadParams
from .envs.state import EnvState, Goal
from .envs.trajectory import TrajState
from .models.emlp.nn import _bilinear_struct, gated
from .models.emlp.zoo import actor_reps, critic_reps, v_critic_reps
from .models.zoo import critic_in
from .utils.config import Config
from .utils.device import resolve_device


def _emlp_shapes(block: str, head: str, rep_in, hidden, rep_out,
                 hidden_num: int = 2):
    """Parameter shapes of an EMLP whose ``i``-th block is named
    ``block.format(i)`` and whose equivariant head is ``head``."""
    reps = (rep_in,) + (hidden,) * hidden_num
    shapes = OrderedDict()
    for i, (rin, rout) in enumerate(zip(reps, reps[1:])):
        g = gated(rout)
        name = block.format(i)
        shapes[f"{name}.linear.kernel"] = (g.size, rin.size)
        shapes[f"{name}.linear.bias"] = (g.size,)
        wdim = _bilinear_struct(g)[2]
        if wdim:
            shapes[f"{name}.bilinear.bi_params"] = (wdim,)
    shapes[f"{head}.kernel"] = (rep_out.size, hidden.size)
    shapes[f"{head}.bias"] = (rep_out.size,)
    return shapes


def _dense_shapes(names, widths):
    """flax ``Dense`` layers ``names[k]`` from ``widths[k]`` to
    ``widths[k + 1]``: kernel ``(nin, nout)``, bias ``(nout,)``."""
    shapes = OrderedDict()
    for name, nin, nout in zip(names, widths, widths[1:]):
        shapes[f"{name}.kernel"] = (nin, nout)
        shapes[f"{name}.bias"] = (nout,)
    return shapes


def _actor_shapes(cfg: Config, agent_id: int):
    """TD3's actor: ``EMLPActorDet``, or ``ActorTD3`` (``Dense_0..2``)
    without ``use_equiv``."""
    if not cfg.use_equiv:
        h = cfg.actor_hidden_dim[agent_id]
        return _dense_shapes(("Dense_0", "Dense_1", "Dense_2"),
                             (cfg.obs_dim_n[agent_id], h, h,
                              cfg.action_dim_n[agent_id]))
    return _emlp_shapes("network.block{}", "network.head",
                        *actor_reps(cfg, cfg.framework, agent_id))


def _mlp_actor_trunk(cfg: Config, agent_id: int):
    h = cfg.actor_hidden_dim[agent_id]
    return h, _dense_shapes(("Dense_0", "Dense_1"),
                            (cfg.obs_dim_n[agent_id], h, h))


def _sac_actor_shapes(cfg: Config, agent_id: int):
    """``EMLPActorSAC``: top-level ``network_block{i}``, ``network_head``
    and the ``log_std_linear`` Dense (kernel ``(nin, nout)``); or
    ``ActorSAC`` (``Dense_0``, ``Dense_1``, ``mean``, ``log_std``) without
    ``use_equiv``."""
    act = cfg.action_dim_n[agent_id]
    if not cfg.use_equiv:
        h, shapes = _mlp_actor_trunk(cfg, agent_id)
        for name in ("mean", "log_std"):
            shapes.update(_dense_shapes((name,), (h, act)))
        return shapes
    rep_in, hidden, rep_out = actor_reps(cfg, cfg.framework, agent_id)
    shapes = _emlp_shapes("network_block{}", "network_head", rep_in, hidden,
                          rep_out)
    shapes["log_std_linear.kernel"] = (hidden.size, act)
    shapes["log_std_linear.bias"] = (act,)
    return shapes


def _ppo_actor_shapes(cfg: Config, agent_id: int):
    """``EMLPActorPPO``: the EMLP ``network`` and ``log_std`` (1, act); or
    ``ActorPPO`` (``Dense_0``, ``Dense_1``, ``mean``, ``log_std``) without
    ``use_equiv``."""
    act = cfg.action_dim_n[agent_id]
    if cfg.use_equiv:
        shapes = _actor_shapes(cfg, agent_id)
    else:
        h, shapes = _mlp_actor_trunk(cfg, agent_id)
        shapes.update(_dense_shapes(("mean",), (h, act)))
    shapes["log_std"] = (1, act)
    return shapes


def _v_critic_shapes(cfg: Config, agent_id: int):
    """``EMLPVCritic``, or ``VCritic`` (``Dense_0..2``) without
    ``use_equiv``; under CTDE over every agent's obs."""
    if not cfg.use_equiv:
        h = cfg.critic_hidden_dim
        return _dense_shapes(("Dense_0", "Dense_1", "Dense_2"),
                             (critic_in(cfg, agent_id, False), h, h, 1))
    return _emlp_shapes("network.block{}", "network.head",
                        *v_critic_reps(cfg, cfg.framework, agent_id,
                                       cfg.module_training))


def _critic_shapes(cfg: Config, agent_id: int):
    """The twin Q critic: ``EMLPCriticTwin``, or ``CriticTwin``
    (``q1_fc1..q2_fc3``) without ``use_equiv``; under CTDE over every
    agent's obs and action."""
    if not cfg.use_equiv:
        h = cfg.critic_hidden_dim
        widths = (critic_in(cfg, agent_id, True), h, h, 1)
        shapes = _dense_shapes(("q1_fc1", "q1_fc2", "q1_fc3"), widths)
        shapes.update(_dense_shapes(("q2_fc1", "q2_fc2", "q2_fc3"), widths))
        return shapes
    reps = critic_reps(cfg, cfg.framework, agent_id, cfg.module_training)
    shapes = _emlp_shapes("network1.block{}", "network1.head", *reps)
    shapes.update(_emlp_shapes("network2.block{}", "network2.head", *reps))
    return shapes


def _params_from_jax(tree: Mapping, shapes) -> "OrderedDict[str, torch.Tensor]":
    """Flax params (with or without the top-level ``params`` key) -> dotted
    names to CPU tensors: flax path ``network/block0/linear/kernel`` becomes
    ``network.block0.linear.kernel``; shapes are checked."""
    p = tree["params"] if "params" in tree else tree
    sd = OrderedDict()
    for key, shape in shapes.items():
        node = p
        for part in key.split("."):
            if part not in node:
                raise KeyError(f"flax params lack {key.replace('.', '/')}")
            node = node[part]
        arr = np.asarray(node)
        if arr.shape != shape:
            raise ValueError(f"{key}: expected shape {shape}, got {arr.shape}")
        sd[key] = torch.from_numpy(np.array(arr))
    return sd


def actor_params_from_jax(tree: Mapping, cfg: Config, agent_id: int):
    """Flax TD3 actor params (``EMLPActorDet``, or ``ActorTD3`` without
    ``cfg.use_equiv``; nested dicts of numpy arrays) -> the port actor's
    ``state_dict`` (CPU tensors)."""
    return _params_from_jax(tree, _actor_shapes(cfg, agent_id))


def sac_actor_params_from_jax(tree: Mapping, cfg: Config, agent_id: int):
    """Flax ``EMLPActorSAC`` (or ``ActorSAC``) params -> the port SAC
    actor's ``state_dict`` (CPU tensors)."""
    return _params_from_jax(tree, _sac_actor_shapes(cfg, agent_id))


def ppo_actor_params_from_jax(tree: Mapping, cfg: Config, agent_id: int):
    """Flax ``EMLPActorPPO`` (or ``ActorPPO``) params -> the port PPO
    actor's ``state_dict`` (``log_std`` and ``network.*``, or ``Dense_*``
    and ``mean.*``; CPU tensors)."""
    return _params_from_jax(tree, _ppo_actor_shapes(cfg, agent_id))


def v_critic_params_from_jax(tree: Mapping, cfg: Config, agent_id: int):
    """Flax ``EMLPVCritic`` (or ``VCritic``) params -> the port V critic's
    ``state_dict`` (``network.*`` or ``Dense_*``; CPU tensors)."""
    return _params_from_jax(tree, _v_critic_shapes(cfg, agent_id))


def critic_params_from_jax(tree: Mapping, cfg: Config, agent_id: int):
    """Flax twin critic params -> the port critic's ``state_dict``:
    ``EMLPCriticTwin`` (``network1.*``, ``network2.*``), or ``CriticTwin``
    (``q1_fc1.*`` .. ``q2_fc3.*``) without ``cfg.use_equiv``; CPU
    tensors."""
    return _params_from_jax(tree, _critic_shapes(cfg, agent_id))


def _params_to_jax(sd: Mapping[str, torch.Tensor], shapes) -> dict:
    """Dotted names to tensors -> flax's ``{"params": ...}`` tree of numpy
    arrays, every level's keys in sorted order (the order of a tree that
    came out of a jitted function or ``unravel``, and so of the JAX
    package's saved actors); shapes are checked."""
    names = sorted(shapes, key=lambda n: tuple(n.split(".")))
    params: dict = {}
    for key in names:
        if key not in sd:
            raise KeyError(f"port params lack {key}")
        arr = sd[key].detach().cpu().numpy()
        if arr.shape != tuple(shapes[key]):
            raise ValueError(f"{key}: expected shape {tuple(shapes[key])}, "
                             f"got {arr.shape}")
        *path, leaf = key.split(".")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.array(arr)
    return {"params": params}


def actor_params_to_jax(sd: Mapping[str, torch.Tensor], cfg: Config,
                        agent_id: int) -> dict:
    """The port TD3 actor's ``state_dict`` -> flax ``EMLPActorDet`` (or
    ``ActorTD3``) params, nested dicts of numpy arrays under ``params``
    (the inverse of ``actor_params_from_jax``)."""
    return _params_to_jax(sd, _actor_shapes(cfg, agent_id))


def sac_actor_params_to_jax(sd: Mapping[str, torch.Tensor], cfg: Config,
                            agent_id: int) -> dict:
    """The port SAC actor's ``state_dict`` -> flax ``EMLPActorSAC`` (or
    ``ActorSAC``) params (the inverse of ``sac_actor_params_from_jax``)."""
    return _params_to_jax(sd, _sac_actor_shapes(cfg, agent_id))


def ppo_actor_params_to_jax(sd: Mapping[str, torch.Tensor], cfg: Config,
                            agent_id: int) -> dict:
    """The port PPO actor's ``state_dict`` -> flax ``EMLPActorPPO`` (or
    ``ActorPPO``) params (the inverse of ``ppo_actor_params_from_jax``)."""
    return _params_to_jax(sd, _ppo_actor_shapes(cfg, agent_id))


def _module_shapes(module: torch.nn.Module):
    return OrderedDict((k, tuple(v.shape))
                       for k, v in module.state_dict().items())


def module_params_from_jax(tree: Mapping, module: torch.nn.Module):
    """Flax params of a network the port mirrors name for name (the
    general engine's ``GeneralEMLP`` and its layers, ``Interface``, the
    diagnostics' ``MLP``: ``block_0/linear/kernel`` is
    ``block_0.linear.kernel``) -> ``module``'s ``state_dict`` (CPU
    tensors), every name and shape checked; load it with
    ``module.load_state_dict``."""
    return _params_from_jax(tree, _module_shapes(module))


def module_params_to_jax(sd: Mapping[str, torch.Tensor],
                         module: torch.nn.Module) -> dict:
    """The inverse of ``module_params_from_jax``: ``module``'s parameters
    (``sd``) -> flax's ``{"params": ...}`` tree of numpy arrays."""
    return _params_to_jax(sd, _module_shapes(module))


def flat_to_jax(flat: torch.Tensor, layout: FlatLayout) -> dict:
    """A flat parameter vector in ``layout``'s order -> its flax
    ``{"params": ...}`` tree of numpy arrays (the inverse of
    ``flat_from_jax``)."""
    return _params_to_jax(layout.views(flat.detach()),
                          OrderedDict(zip(layout.names, layout.shapes)))


def flat_from_jax(tree: Mapping, layout: FlatLayout, device=None,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A flax param tree -> its flat vector in ``layout``'s order, which is
    ``ravel_pytree``'s."""
    sd = _params_from_jax(tree, OrderedDict(zip(layout.names, layout.shapes)))
    flat = layout.ravel(sd)
    return flat.to(resolve_device(device), dtype or flat.dtype)


def _optax_states(tree: Mapping):
    """The ``ScaleByAdamState`` (``adam``) and ``ScaleByScheduleState``
    (``schedule``) nodes of an optax chain state."""
    found = {}

    def walk(node):
        if not isinstance(node, Mapping):
            return
        keys = set(node)
        if {"count", "mu", "nu"} <= keys:
            found["adam"] = node
        elif keys == {"count"}:
            found["schedule"] = node
        else:
            for v in node.values():
                walk(v)
    walk(tree)
    return found


def _vec(a, device, dtype):
    t = torch.from_numpy(np.array(np.asarray(a)))
    return t.to(device, dtype or t.dtype)


def _opt_state_from_jax(tree: Mapping, device, dtype) -> OptState:
    """The flat optax chain state (clip, then adamw: ``ScaleByAdamState``,
    the decay's empty state, ``ScaleByScheduleState``) -> ``OptState``."""
    found = _optax_states(tree)
    if set(found) != {"adam", "schedule"}:
        raise KeyError(f"optax state lacks {({'adam', 'schedule'} - set(found))}")

    adam = found["adam"]
    return OptState(int(np.asarray(adam["count"])),
                    _vec(adam["mu"], device, dtype),
                    _vec(adam["nu"], device, dtype),
                    int(np.asarray(found["schedule"]["count"])))


def td3_state_from_jax(tree: Mapping, agent, dtype: Optional[torch.dtype] = None):
    """A JAX ``TD3State`` as nested dicts of numpy arrays (actor, critic,
    both targets, both optax chain states, ``total_it``) -> the port's
    ``TD3State`` for ``agent`` (an ``algos.td3.TD3Agent``, EMLP or MLP) on
    its device, bound to its networks."""
    dev = agent.device
    dtype = dtype or agent.dtype
    al, cl = agent.actor_layout, agent.critic_layout
    return agent.make_state(
        flat_from_jax(tree["actor"], al, dev, dtype),
        flat_from_jax(tree["critic"], cl, dev, dtype),
        flat_from_jax(tree["actor_target"], al, dev, dtype),
        flat_from_jax(tree["critic_target"], cl, dev, dtype),
        _opt_state_from_jax(tree["actor_opt"], dev, dtype),
        _opt_state_from_jax(tree["critic_opt"], dev, dtype),
        int(np.asarray(tree["total_it"])))


def sac_state_from_jax(tree: Mapping, agent,
                       dtype: Optional[torch.dtype] = None):
    """A JAX ``SACState`` as nested dicts of numpy arrays (actor, critic,
    critic target, both flat optax chain states, ``log_alpha``, its
    ``optax.adamw`` state and ``total_it``) -> the port's ``SACState`` for
    ``agent`` (an ``algos.sac.SACAgent``) on its device, bound to its
    networks.  ``log_alpha`` and its moments stay float32."""
    dev = agent.device
    dtype = dtype or agent.dtype
    al, cl = agent.actor_layout, agent.critic_layout
    adam = _optax_states(tree["alpha_opt"]).get("adam")
    if adam is None:
        raise KeyError("alpha_opt lacks its ScaleByAdamState")
    f32 = torch.float32
    return agent.make_state(
        flat_from_jax(tree["actor"], al, dev, dtype),
        flat_from_jax(tree["critic"], cl, dev, dtype),
        flat_from_jax(tree["critic_target"], cl, dev, dtype),
        _opt_state_from_jax(tree["actor_opt"], dev, dtype),
        _opt_state_from_jax(tree["critic_opt"], dev, dtype),
        _vec(tree["log_alpha"], dev, f32),
        AlphaOptState(int(np.asarray(adam["count"])),
                      _vec(adam["mu"], dev, f32), _vec(adam["nu"], dev, f32)),
        int(np.asarray(tree["total_it"])))


def ppo_state_from_jax(tree: Mapping, agent,
                       dtype: Optional[torch.dtype] = None):
    """A JAX ``PPOState`` as nested dicts of numpy arrays (actor, critic,
    both flat optax chain states, the float32 ``entropy_coef`` and
    ``total_it``) -> the port's ``PPOState`` for ``agent`` (an
    ``algos.ppo.PPOAgent``) on its device, bound to its networks.
    ``entropy_coef`` stays float32."""
    dev = agent.device
    dtype = dtype or agent.dtype
    return agent.make_state(
        flat_from_jax(tree["actor"], agent.actor_layout, dev, dtype),
        flat_from_jax(tree["critic"], agent.critic_layout, dev, dtype),
        _opt_state_from_jax(tree["actor_opt"], dev, dtype),
        _opt_state_from_jax(tree["critic_opt"], dev, dtype),
        _vec(tree["entropy_coef"], dev, torch.float32),
        int(np.asarray(tree["total_it"])))


def replay_state_from_jax(tree: Mapping, obs_dims, act_dims, device=None,
                          dtype: Optional[torch.dtype] = None) -> ReplayState:
    """A JAX ``ReplayState`` (``data``, ``ptr``, ``filled``) -> the port's,
    with host integers for the cursor and the fill."""
    data = torch.from_numpy(np.array(np.asarray(tree["data"])))
    return ReplayState(
        data=data.to(resolve_device(device), dtype or data.dtype),
        ptr=int(np.asarray(tree["ptr"])), filled=int(np.asarray(tree["filled"])),
        dims=(tuple(int(d) for d in obs_dims), tuple(int(d) for d in act_dims)))


_NESTED = {"env": EnvState, "traj": TrajState, "goal": Goal,
           "params": QuadParams}


def _build(cls, d: Mapping, device, dtype):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            raise KeyError(f"{cls.__name__} field {f.name!r} missing")
        v = d[f.name]
        if f.name in _NESTED and isinstance(v, Mapping):
            kw[f.name] = _build(_NESTED[f.name], v, device, dtype)
            continue
        arr = np.asarray(v)
        t = torch.from_numpy(np.array(arr))
        if arr.dtype.kind == "f" and dtype is not None:
            t = t.to(dtype)
        elif arr.dtype.kind in "iu":
            t = t.to(torch.int32)
        kw[f.name] = t.to(device)
    return cls(**kw)


def _float_dtypes(tree: Mapping, prefix: str = "") -> dict:
    """``{path: numpy dtype}`` of the floating leaves of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_float_dtypes(v, f"{prefix}{k}."))
        elif np.asarray(v).dtype.kind == "f":
            out[prefix + k] = np.asarray(v).dtype
    return out


def _one_float_dtype(tree: Mapping) -> None:
    """Raise where a JAX state's float fields disagree in dtype (JAX's
    float32 DOP853 tick under x64 returns ``env.x``/``env.R`` in float64,
    ``dynamics.py:147, 152``)."""
    kinds = _float_dtypes(tree)
    widest = max(kinds.values(), key=lambda d: d.itemsize)
    if any(d != widest for d in kinds.values()):
        wide = [p for p, d in kinds.items() if d == widest]
        raise ValueError(f"JAX state mixes float dtypes: {widest} in "
                         f"{', '.join(wide)}; pass dtype= to cast "
                         "explicitly")


def env_state_from_numpy(tree: Mapping[str, Any], device=None,
                         dtype: Optional[torch.dtype] = None) -> BatchedEnvState:
    """A JAX ``BatchedEnvState`` as nested dicts of numpy arrays -> the port's
    ``BatchedEnvState`` on ``device`` (default: the card), in any trajectory
    mode and after any integrator.  JAX PRNG keys are dropped; float fields
    keep their dtype unless ``dtype`` is given.  A state whose float fields
    disagree in dtype raises unless ``dtype`` names the cast."""
    if dtype is None:
        _one_float_dtype(tree)
    dev = resolve_device(device)
    return BatchedEnvState(env=_build(EnvState, tree["env"], dev, dtype),
                           traj=_build(TrajState, tree["traj"], dev, dtype))


def env_from_numpy(tree: Mapping[str, Any], device=None,
                   dtype: Optional[torch.dtype] = None) -> EnvState:
    """One JAX ``EnvState`` (a single env's, as the Gym API holds it;
    nested dicts of numpy arrays) -> the port's ``EnvState`` on ``device``
    (default: the card), with ``env_state_from_numpy``'s rules."""
    if dtype is None:
        _one_float_dtype(tree)
    return _build(EnvState, tree, resolve_device(device), dtype)
