"""Carry weights and env state across from the JAX package.

Both functions take numpy arrays (nested dicts, as
``flax.serialization.to_state_dict`` plus ``np.asarray`` gives them), never
JAX objects, so this module imports no JAX.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Mapping, Optional

import numpy as np
import torch

from .envs.batch import BatchedEnvState
from .envs.params import QuadParams
from .envs.state import EnvState, Goal
from .envs.trajectory import TrajState
from .models.emlp.nn import _bilinear_struct, gated
from .models.emlp.zoo import actor_reps
from .utils.config import Config
from .utils.device import resolve_device


def _actor_shapes(cfg: Config, agent_id: int, hidden_num: int = 2):
    rep_in, hidden, rep_out = actor_reps(cfg, cfg.framework, agent_id)
    reps = (rep_in,) + (hidden,) * hidden_num
    shapes = OrderedDict()
    for i, (rin, rout) in enumerate(zip(reps, reps[1:])):
        g = gated(rout)
        shapes[f"network.block{i}.linear.kernel"] = (g.size, rin.size)
        shapes[f"network.block{i}.linear.bias"] = (g.size,)
        wdim = _bilinear_struct(g)[2]
        if wdim:
            shapes[f"network.block{i}.bilinear.bi_params"] = (wdim,)
    shapes["network.head.kernel"] = (rep_out.size, hidden.size)
    shapes["network.head.bias"] = (rep_out.size,)
    return shapes


def actor_params_from_jax(tree: Mapping, cfg: Config, agent_id: int):
    """Flax ``EMLPActorDet`` params (nested dicts of numpy arrays, with or
    without the top-level ``params`` key) -> the port actor's
    ``state_dict`` (CPU tensors).  Flax path ``network/block0/linear/kernel``
    becomes key ``network.block0.linear.kernel``; shapes are checked against
    the actor's reps."""
    p = tree["params"] if "params" in tree else tree
    sd = OrderedDict()
    for key, shape in _actor_shapes(cfg, agent_id).items():
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
