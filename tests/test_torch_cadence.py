"""PyTorch port vs the JAX package: the off-policy superstep at a learning
run's cadence, ``rollout_len`` 3 and ``n_updates`` 4 (the reference's runs
train at ``updates_per_step`` 32: many ticks and updates a superstep), for
TD3 and SAC Mod-EMLP (DTDE), against ``make_sharded_td3_superstep`` on a
1-device CPU mesh in float32, 2 warm + 2 train supersteps from the same
envs, ring and learner states with JAX's draws for every tick and update
(``test_torch_td3.py::superstep_vs_jax``; MATD3's is in
``test_torch_matd3.py``).

Tolerances: the float32 superstep bounds of ``test_torch_td3.py`` and
``test_torch_sac.py`` (losses within 1e-4 relative; learner states within
1e-5 (TD3) and 1e-4 (SAC) of their largest entry: JAX under x64 draws the
target noise and SAC's actor-loss noise in float64).
"""
import pytest
import torch

from test_torch_sac import SAC
from test_torch_td3 import TD3, superstep_vs_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("algo", ["TD3", "SAC"])
def test_cadence_matches_jax(algo):
    """2 warm + 2 train supersteps of 3 ticks and 4 updates each (the ring
    of 28 rows wraps every superstep; the delayed actor and target steps
    fall inside a superstep), the shapes of ``tests/test_parallel.py:35,
    102``."""
    spec, kw = (TD3, {}) if algo == "TD3" else (SAC, dict(rl_algo="SAC"))
    superstep_vs_jax(spec, supersteps=(2, 2), rollout_len=3, n_updates=4,
                     **kw)
