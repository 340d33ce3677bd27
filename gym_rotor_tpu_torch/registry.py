"""Environment registry (port of ``gym_rotor_tpu/registry.py``): ids ->
the Gym API's env classes, ``Quad-v0``, ``Coupled-v0`` and
``Decoupled-v0`` built in."""
from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, tuple] = {}


def register(env_id: str, entry_point: Callable, **default_kwargs):
    _REGISTRY[env_id] = (entry_point, default_kwargs)


def make(env_id: str, **kwargs):
    """Build a registered env; ``kwargs`` override the registered
    defaults (``device="cpu"`` for the plain path; the card otherwise)."""
    if env_id not in _REGISTRY:
        _ensure_builtin()
    if env_id not in _REGISTRY:
        raise KeyError(
            f"Unknown env id {env_id!r}; known: {sorted(_REGISTRY)}")
    entry, defaults = _REGISTRY[env_id]
    return entry(**{**defaults, **kwargs})


def _ensure_builtin():
    from .envs.gym_api import CoupledWrapper, DecoupledWrapper, QuadEnv

    # max_episode_steps=10000, as the reference registers Quad-v0
    if "Quad-v0" not in _REGISTRY:
        register("Quad-v0", QuadEnv, max_episode_steps=10000)
        register("Coupled-v0", CoupledWrapper, max_episode_steps=10000)
        register("Decoupled-v0", DecoupledWrapper, max_episode_steps=10000)
