"""PyTorch port vs the JAX package: one update of CTDE SAC (the joint target
action from every agent's current actor on its ``next_obs``, the actor
loss's joint action beside the other agents' current samples) with EMLP and
MLP networks, and two float32 CTDE PPO supersteps.  The networks and the
other CTDE updates are held in ``test_torch_ctde.py``.

Tolerances: one update within 1e-9 of the compared vector's largest entry,
float64 (``test_torch_sac.py``'s check); the supersteps within
``test_torch_ppo.py``'s float32 bounds.
"""
import pytest
import torch

from test_torch_ppo import ppo_superstep_vs_jax
from test_torch_sac import train_step_vs_jax as sac_train_step_vs_jax

torch.set_num_threads(1)
CTDE = dict(module_training="CTDE")
FAMILIES = {"emlp": {}, "mlp": dict(use_equiv=False)}


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sac_ctde_train_step_matches_jax(family, gate):
    """One CTDE SAC ``train_step`` (the critic target's Polyak not taken
    and taken; the temperature auto-tuned) within 1e-9, float64
    (``test_torch_sac.py``'s check)."""
    sac_train_step_vs_jax(gate, True, **CTDE, **FAMILIES[family])



def test_ppo_ctde_superstep_matches_jax():
    """2 CTDE PPO-EMLP supersteps against ``make_sharded_ppo_superstep``,
    float32, with JAX's draws."""
    ppo_superstep_vs_jax(**CTDE)
