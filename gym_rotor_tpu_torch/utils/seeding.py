"""Seeding and error-extraction helpers (port of
``gym_rotor_tpu/utils/seeding.py``)."""
from __future__ import annotations

import os
import random

import numpy as np


def set_seed(env=None, seed: int = 1992) -> None:
    """Seed Python's and NumPy's global RNGs, which drive the Gym API's
    resets in the reference's order, and the env's spaces where it has
    them.  The torch generators of the batched paths are seeded explicitly
    by their callers."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    if env is not None:
        for space in ("action_space", "observation_space"):
            sp = getattr(env, space, None)
            if sp is not None and hasattr(sp, "seed"):
                sp.seed(seed)


def get_error_state(norm_obs_n, x_lim, v_lim, eIx_lim, eIb1_lim, framework):
    """De-normalised tracking errors from the per-agent observations
    (``seeding.py:21-39``)."""
    if framework == "MODUL":
        o1, o2 = norm_obs_n[0], norm_obs_n[1]
        ex = o1[0:3] * x_lim
        eIx = o1[3:6] * eIx_lim
        ev = o1[6:9] * v_lim
        eb1 = o2[0] * np.pi
        eIb1 = o2[1] * eIb1_lim
    else:
        o = norm_obs_n[0]
        ex = o[0:3] * x_lim
        eIx = o[3:6] * eIx_lim
        ev = o[6:9] * v_lim
        eb1 = o[18] * np.pi
        eIb1 = o[19] * eIb1_lim
    return ex, eIx, ev, eb1, eIb1


def benchmark_reward_func(ex, eb1) -> float:
    """interp(-||ex|| - |eb1|, [-2, 0], [0, 1]) (``seeding.py:42-46``)."""
    r = -np.linalg.norm(ex) - abs(eb1)
    return float(np.clip((r + 2.0) / 2.0, 0.0, 1.0))
