"""Carry weights, learner state, replay rings and env state across from the
JAX package.

Every function takes numpy arrays (nested dicts, as
``flax.serialization.to_state_dict`` plus ``np.asarray`` gives them), never
JAX objects, so this module imports no JAX.  A network's flat parameter
vector is built in ``ravel_pytree`` order (the dotted flax paths sorted as
path tuples, ``algos/common.py::FlatLayout``), so the JAX flat optimizer
state (``flat_init``'s ``mu``/``nu``) carries across as it is.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Mapping, Optional

import numpy as np
import torch

from .algos.common import FlatLayout, OptState
from .algos.replay import ReplayState
from .envs.batch import BatchedEnvState
from .envs.params import QuadParams
from .envs.state import EnvState, Goal
from .envs.trajectory import TrajState
from .models.emlp.nn import _bilinear_struct, gated
from .models.emlp.zoo import actor_reps, critic_reps
from .utils.config import Config
from .utils.device import resolve_device


def _emlp_shapes(prefix: str, rep_in, hidden, rep_out, hidden_num: int = 2):
    reps = (rep_in,) + (hidden,) * hidden_num
    shapes = OrderedDict()
    for i, (rin, rout) in enumerate(zip(reps, reps[1:])):
        g = gated(rout)
        shapes[f"{prefix}.block{i}.linear.kernel"] = (g.size, rin.size)
        shapes[f"{prefix}.block{i}.linear.bias"] = (g.size,)
        wdim = _bilinear_struct(g)[2]
        if wdim:
            shapes[f"{prefix}.block{i}.bilinear.bi_params"] = (wdim,)
    shapes[f"{prefix}.head.kernel"] = (rep_out.size, hidden.size)
    shapes[f"{prefix}.head.bias"] = (rep_out.size,)
    return shapes


def _actor_shapes(cfg: Config, agent_id: int):
    return _emlp_shapes("network", *actor_reps(cfg, cfg.framework, agent_id))


def _critic_shapes(cfg: Config, agent_id: int):
    reps = critic_reps(cfg, cfg.framework, agent_id, cfg.module_training)
    shapes = _emlp_shapes("network1", *reps)
    shapes.update(_emlp_shapes("network2", *reps))
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
    """Flax ``EMLPActorDet`` params (nested dicts of numpy arrays) -> the
    port actor's ``state_dict`` (CPU tensors)."""
    return _params_from_jax(tree, _actor_shapes(cfg, agent_id))


def critic_params_from_jax(tree: Mapping, cfg: Config, agent_id: int):
    """Flax ``EMLPCriticTwin`` params -> the port critic's ``state_dict``
    (``network1.*``, ``network2.*``; CPU tensors)."""
    return _params_from_jax(tree, _critic_shapes(cfg, agent_id))


def flat_from_jax(tree: Mapping, layout: FlatLayout, device=None,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A flax param tree -> its flat vector in ``layout``'s order, which is
    ``ravel_pytree``'s."""
    sd = _params_from_jax(tree, OrderedDict(zip(layout.names, layout.shapes)))
    flat = layout.ravel(sd)
    return flat.to(resolve_device(device), dtype or flat.dtype)


def _opt_state_from_jax(tree: Mapping, device, dtype) -> OptState:
    """The flat optax chain state (clip, then adamw: ``ScaleByAdamState``,
    the decay's empty state, ``ScaleByScheduleState``) -> ``OptState``."""
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
    if set(found) != {"adam", "schedule"}:
        raise KeyError(f"optax state lacks {({'adam', 'schedule'} - set(found))}")

    def vec(a):
        t = torch.from_numpy(np.array(np.asarray(a)))
        return t.to(device, dtype or t.dtype)
    adam = found["adam"]
    return OptState(int(np.asarray(adam["count"])), vec(adam["mu"]),
                    vec(adam["nu"]), int(np.asarray(found["schedule"]["count"])))


def td3_state_from_jax(tree: Mapping, agent, dtype: Optional[torch.dtype] = None):
    """A JAX ``TD3State`` as nested dicts of numpy arrays (actor, critic,
    both targets, both optax chain states, ``total_it``) -> the port's
    ``TD3State`` for ``agent`` (an ``algos.td3.TD3Agent``) on its device,
    bound to its networks."""
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


def env_state_from_numpy(tree: Mapping[str, Any], device=None,
                         dtype: Optional[torch.dtype] = None) -> BatchedEnvState:
    """A JAX ``BatchedEnvState`` as nested dicts of numpy arrays -> the port's
    ``BatchedEnvState`` on ``device`` (default: the card).  JAX PRNG keys
    are dropped; float fields keep their dtype unless ``dtype`` is given."""
    dev = resolve_device(device)
    return BatchedEnvState(env=_build(EnvState, tree["env"], dev, dtype),
                           traj=_build(TrajState, tree["traj"], dev, dtype))
