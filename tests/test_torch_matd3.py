"""PyTorch port vs the JAX package: MATD3-EMLP (TD3 under CTDE) supersteps
against ``make_sharded_td3_superstep`` on a 1-device CPU mesh, float32, at
the default cadence (one tick, one update) and at a learning run's (3 ticks,
4 updates a superstep); each tick's env and acting draws and each update's
indices and draws are JAX's own (``test_torch_td3.py::superstep_vs_jax``).

Tolerances: ``test_torch_td3.py``'s float32 superstep bounds (env state,
ring and episode statistics within the tick's float32 bounds; losses within
1e-4 relative and the learner states within 1e-5 of their largest entry,
JAX under x64 drawing the target noise in float64, ``td3.py:228``).
"""
import torch

from test_torch_td3 import TD3, superstep_vs_jax

torch.set_num_threads(1)
CTDE = dict(module_training="CTDE")


def test_matd3_superstep_matches_jax():
    """2 warm + 3 train MATD3-EMLP supersteps against the 1-device JAX
    superstep, float32, with JAX's draws (the CTDE target noises included)."""
    superstep_vs_jax(TD3, **CTDE)


def test_matd3_cadence_matches_jax():
    """2 warm + 2 train MATD3-EMLP supersteps of ``rollout_len`` 3 and
    ``n_updates`` 4 (12 ticks and 8 updates, the ring of 28 rows wrapping
    each superstep), the shapes of ``tests/test_parallel.py:35,102``."""
    superstep_vs_jax(TD3, supersteps=(2, 2), rollout_len=3, n_updates=4,
                     **CTDE)
