"""One PPO minibatch step at actor (32, 8) and critic 128 (past the
defaults' (16, 4) / 62 and the narrow (8, 4) / 8 the other learner tests
run), step for step against the JAX package with injected draws, float64:
the check of ``test_torch_ppo.py::train_step_vs_jax`` at this width.  On
the CPU every kernel wrapper runs its plain twin; on the card this width
runs the run-time-width kernels (``chip_smoke.py`` phase 26).  The
update's largest EMLP basis reaches XLA as an argument, not a constant
(``torch_jax_fixtures.jit_bases_as_args``)."""
from test_torch_ppo import train_step_vs_jax
from torch_jax_fixtures import jax_rho_memo  # noqa: F401

WIDE = dict(actor_hidden_dim=(32, 8), critic_hidden_dim=128)


def test_ppo_minibatch_step_matches_jax_at_width():
    """One PPO ``train_step`` (2 epochs of 4 actor and 4 critic minibatches
    over a 16-row horizon, the actor and the V critic both updated) at
    (32, 8) / 128: losses, both networks, the moments, the counts and
    ``entropy_coef``, 1e-9."""
    train_step_vs_jax(bases_as_args=True, **WIDE)
