"""One TD3 update at actor (32, 8) and critic 128 (past the defaults'
(16, 4) / 62 and the narrow (8, 4) / 8 the other learner tests run), step
for step against the JAX package with injected draws, float64: the check
of ``test_torch_td3.py::train_step_vs_jax`` at this width.  On the CPU
every kernel wrapper runs its plain twin; on the card this width runs the
run-time-width kernels (``chip_smoke.py`` phase 26).  The flax networks'
equivariant bases at critic 128 and XLA's compile of the update take most
of this file's time; the bases' group actions are memoized
(``jax_rho_memo``), the same numbers, and the update's largest basis
reaches XLA as an argument, not a constant (``jit_bases_as_args``)."""
from test_torch_td3 import train_step_vs_jax
from torch_jax_fixtures import jax_rho_memo  # noqa: F401

WIDE = dict(actor_hidden_dim=(32, 8), critic_hidden_dim=128)


def test_td3_update_matches_jax_at_width():
    """One TD3 ``train_step`` for both agents at (32, 8) / 128 with the
    delayed actor step not taken (``total_it`` 1 -> 2; the gated step's
    second XLA program would double the file's time; the actor's update at
    this width is ``test_torch_widths_ppo.py``'s): losses, parameters,
    both targets, ``mu``/``nu`` and the counts, 1e-9."""
    train_step_vs_jax(False, bases_as_args=True, **WIDE)
