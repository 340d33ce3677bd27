"""Checkpointing (port of ``gym_rotor_tpu/utils/checkpoint.py``).

Two tiers:

* ``save_actor`` / ``load_actor``: the actor weights alone, under the
  reference's file names ``{algo}_{framework}_{steps/1000}k_steps_agent_{id}
  [_solved]_{seed}.msgpack`` (``_actor_path``, the same float formatting:
  ``450.016k``), in flax's byte layout (``utils/msgpack.py``): the flax
  ``{"params": ...}`` tree of numpy arrays that ``convert.flat_to_jax``
  makes.  The JAX package and the port read each other's actor files, and
  write the same bytes for the same parameters.
* ``save_train_state`` / ``load_train_state``: the whole learner state, in
  the port's own versioned layout (the same codec).  The map starts with
  ``format`` (``TRAIN_STATE_FORMAT``) and ``version``
  (``TRAIN_STATE_VERSION``); a file without them, such as a JAX train
  state, raises and names what it found.  It holds each agent's state
  (flat parameters and targets, ``OptState``, ``total_it``; SAC's
  ``log_alpha`` and its optimizer, PPO's ``entropy_coef``), both
  generators' ``get_state()``, ``total_timesteps``, ``explor_noise_std``
  and, when asked (``checkpoint_replay``), the replay ring: the list the
  JAX driver keeps (``train.py:236-245``), with torch generators in place of
  the PRNG key.

  Saved over a process group of more than one rank (``train.py``), the map
  also holds ``mesh``: the ``world`` size; ``ranks``, each rank's
  generators and SAC temperature (``log_alpha``, ``alpha_opt``: each rank
  steps its own, ``sac.py:264-271``), in rank order; and the env state
  (dotted field paths), the observations and ``ep_ret``, each the ranks'
  rows concatenated in rank order, as is the ring.  A file saved at world
  1 has no ``mesh`` and is byte for byte what a learner without a process
  group writes.  The world size must match at load (``saved_world``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from . import msgpack

TRAIN_STATE_FORMAT = "gym_rotor_tpu_torch.train_state"
TRAIN_STATE_VERSION = 1


def _actor_path(model_dir, rl_algo, framework, total_steps, agent_id, seed,
                solved=False):
    tag = "_solved" if solved else ""
    return os.path.join(
        model_dir,
        f"{rl_algo}_{framework}_{total_steps / 1000}k_steps_agent_"
        f"{agent_id}{tag}_{seed}.msgpack",
    )


def save_actor(model_dir, actor_params, rl_algo, framework, total_steps,
               agent_id, seed, solved=False) -> str:
    """Write ``actor_params`` (a flax tree of numpy arrays,
    ``convert.flat_to_jax``) to its reference file name; returns the
    path."""
    os.makedirs(model_dir, exist_ok=True)
    path = _actor_path(model_dir, rl_algo, framework, total_steps, agent_id,
                       seed, solved)
    with open(path, "wb") as f:
        f.write(msgpack.packb(actor_params))
    return path


def _check_like(tree, template, path="") -> None:
    """``tree`` has ``template``'s maps and keys, and its arrays the
    template's shapes and dtypes (flax's ``from_bytes`` checks the keys)."""
    if isinstance(template, Mapping):
        if not isinstance(tree, Mapping):
            raise ValueError(f"{path or '/'}: expected a map, found "
                             f"{type(tree).__name__}")
        missing = set(template) - set(tree)
        if missing:
            raise ValueError(f"{path or '/'}: the file lacks "
                             f"{sorted(missing)}")
        for k, v in template.items():
            _check_like(tree[k], v, f"{path}/{k}")
    elif isinstance(template, np.ndarray):
        if not isinstance(tree, np.ndarray) or tree.shape != template.shape \
                or tree.dtype != template.dtype:
            found = (f"{tree.dtype}{list(tree.shape)}"
                     if isinstance(tree, np.ndarray) else type(tree).__name__)
            raise ValueError(f"{path}: expected {template.dtype}"
                             f"{list(template.shape)}, found {found}")


def load_actor(path, template_params):
    """The flax tree of numpy arrays in ``path``, checked against
    ``template_params`` (the same structure, shapes and dtypes)."""
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read())
    _check_like(tree, template_params)
    return tree


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------
def _to_tree(x):
    """An agent state (dataclasses of tensors and host ints) -> maps of
    numpy arrays and Python scalars."""
    if dataclasses.is_dataclass(x):
        return {f.name: _to_tree(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (bool, int, float)):
        return x
    raise TypeError(f"cannot checkpoint {type(x).__name__}")


def _from_tree(tree, template, device, path):
    """Rebuild ``template``'s type from ``tree``: tensors on ``device``
    (the saved dtype, which must be the template's), host ints as ints."""
    if dataclasses.is_dataclass(template):
        _check_keys(tree, [f.name for f in dataclasses.fields(template)],
                    path)
        return type(template)(**{
            f.name: _from_tree(tree[f.name], getattr(template, f.name),
                               device, f"{path}/{f.name}")
            for f in dataclasses.fields(template)})
    if isinstance(template, torch.Tensor):
        if not isinstance(tree, np.ndarray) or \
                tuple(tree.shape) != tuple(template.shape) or \
                torch.from_numpy(np.empty(0, tree.dtype)).dtype \
                != template.dtype:
            found = (f"{tree.dtype}{list(tree.shape)}"
                     if isinstance(tree, np.ndarray) else type(tree).__name__)
            raise ValueError(f"{path}: expected {template.dtype}"
                             f"{list(template.shape)}, found {found}")
        return torch.from_numpy(np.array(tree)).to(device)
    if type(tree) is not type(template):
        raise ValueError(f"{path}: expected {type(template).__name__}, "
                         f"found {type(tree).__name__}")
    return tree


def _check_keys(tree, keys, path) -> None:
    if not isinstance(tree, Mapping) or set(tree) != set(keys):
        found = sorted(tree) if isinstance(tree, Mapping) else \
            type(tree).__name__
        raise ValueError(f"{path or '/'}: expected {sorted(keys)}, found "
                         f"{found}")


def train_state_tree(cfg, states, generators: Mapping[str, torch.Generator],
                     total_timesteps: int, explor_noise_std: float,
                     replay=None) -> Dict[str, Any]:
    """The train-state map ``save_train_state`` writes: ``format`` and
    ``version`` first, the configuration's identity (algorithm, framework,
    critics' training, networks), the agents' states, the generators'
    states (uint8 arrays), the counters and, when given, the replay ring
    (``data``, ``ptr``, ``filled``)."""
    tree = {
        "format": TRAIN_STATE_FORMAT,
        "version": TRAIN_STATE_VERSION,
        "config": _identity(cfg),
        "agents": [_to_tree(st) for st in states],
        "generators": {k: g.get_state().numpy() for k, g in
                       generators.items()},
        "total_timesteps": int(total_timesteps),
        "explor_noise_std": float(explor_noise_std),
    }
    if replay is not None:
        tree["replay"] = {"data": replay.data.detach().cpu().numpy(),
                          "ptr": int(replay.ptr),
                          "filled": int(replay.filled)}
    return tree


def _identity(cfg) -> Dict[str, Any]:
    return {"rl_algo": cfg.rl_algo, "framework": cfg.framework,
            "module_training": cfg.module_training,
            "use_equiv": bool(cfg.use_equiv)}


def save_train_state(path: str, tree: Mapping[str, Any]) -> str:
    """Write a ``train_state_tree`` map to ``path``; returns the path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = msgpack.packb(dict(tree))
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def read_train_state(path: str) -> Dict[str, Any]:
    """The map in ``path``, after checking its ``format`` and ``version``:
    a file of another layout (a JAX train state has ``states`` and ``key``
    and no ``format``) raises ``ValueError`` naming what it holds."""
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read())
    if not isinstance(tree, Mapping) or \
            tree.get("format") != TRAIN_STATE_FORMAT:
        found = (f"top-level keys {sorted(tree)}" if isinstance(tree, Mapping)
                 else f"a {type(tree).__name__}")
        raise ValueError(
            f"{path} is not a {TRAIN_STATE_FORMAT} file (format "
            f"{tree.get('format') if isinstance(tree, Mapping) else None!r}; "
            f"found {found})")
    if tree.get("version") != TRAIN_STATE_VERSION:
        raise ValueError(f"{path}: train-state version "
                         f"{tree.get('version')!r}, this package reads "
                         f"version {TRAIN_STATE_VERSION}")
    return tree


def load_train_state(path: str, cfg, agents, states, device
                     ) -> Dict[str, Any]:
    """Read ``path`` and rebuild what it holds for ``cfg``'s learner:
    ``states`` (each through its agent's ``make_state``, which binds the
    networks to the new vectors and so bumps their ``param_version``),
    ``generators`` (uint8 state tensors for ``Generator.set_state``),
    ``total_timesteps``, ``explor_noise_std`` and, if saved, ``replay``
    (``data``, ``ptr``, ``filled``).  ``states`` are the templates: the
    saved shapes and dtypes must be theirs."""
    tree = read_train_state(path)
    if tree.get("config") != _identity(cfg):
        raise ValueError(f"{path} was saved for {tree.get('config')}, not "
                         f"{_identity(cfg)}")
    if len(tree["agents"]) != len(states):
        raise ValueError(f"{path} holds {len(tree['agents'])} agents, the "
                         f"configuration has {len(states)}")
    out = {"states": [], "generators": {
        k: torch.from_numpy(np.array(v)) for k, v in
        tree["generators"].items()}}
    for i, (agent, st, saved) in enumerate(zip(agents, states,
                                               tree["agents"])):
        rebuilt = _from_tree(saved, st, device, f"/agents/{i}")
        out["states"].append(agent.make_state(
            **{f.name: getattr(rebuilt, f.name)
               for f in dataclasses.fields(rebuilt)}))
    out["total_timesteps"] = int(tree["total_timesteps"])
    out["explor_noise_std"] = float(tree["explor_noise_std"])
    if "replay" in tree:
        out["replay"] = tree["replay"]
    if "mesh" in tree:
        out["mesh"] = tree["mesh"]
    return out


# ---------------------------------------------------------------------------
# Over a process group
# ---------------------------------------------------------------------------
RANK_FIELDS = ("log_alpha", "alpha_opt")   # an agent state's per-rank fields


def rank_tree(states, generators: Mapping[str, torch.Generator]
              ) -> Dict[str, Any]:
    """One rank's own part of the train state: its generators' states and,
    per agent, the state fields that differ between ranks
    (``RANK_FIELDS``: SAC's temperature)."""
    return {"generators": {k: g.get_state().numpy() for k, g in
                           generators.items()},
            "agents": [{f: _to_tree(getattr(st, f)) for f in RANK_FIELDS
                        if hasattr(st, f)} for st in states]}


def mesh_tree(ranks, env: Mapping[str, np.ndarray], obs, ep_ret
              ) -> Dict[str, Any]:
    """The ``mesh`` map: ``world``, every rank's ``rank_tree`` in rank
    order and the gathered env state (``{dotted path: array}``),
    observations and ``ep_ret``."""
    return {"world": len(ranks), "ranks": list(ranks), "env": dict(env),
            "obs": list(obs), "ep_ret": ep_ret}


def saved_world(loaded: Mapping[str, Any]) -> int:
    """The world size a ``load_train_state`` result was saved by (1 for a
    file without ``mesh``)."""
    return int(loaded["mesh"]["world"]) if "mesh" in loaded else 1


def load_rank_tree(tree, states, device, path) -> Dict[str, torch.Tensor]:
    """Apply a ``rank_tree`` to ``states`` in place (the per-rank fields,
    checked against the current ones) and return its generator states
    (uint8 tensors)."""
    _check_keys(tree, ["generators", "agents"], path)
    if len(tree["agents"]) != len(states):
        raise ValueError(f"{path} holds {len(tree['agents'])} agents, the "
                         f"configuration has {len(states)}")
    for i, (st, saved) in enumerate(zip(states, tree["agents"])):
        fields = [f for f in RANK_FIELDS if hasattr(st, f)]
        _check_keys(saved, fields, f"{path}/agents/{i}")
        for f in fields:
            setattr(st, f, _from_tree(saved[f], getattr(st, f), device,
                                      f"{path}/agents/{i}/{f}"))
    return {k: torch.from_numpy(np.array(v))
            for k, v in tree["generators"].items()}
