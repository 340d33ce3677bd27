"""Helpers that the port's test files (``test_torch_*.py``) use to cut the
time their JAX references take:

- ``jax_rho_memo``, a module-scoped fixture: the JAX package's pure
  ``reps.Atom.rho`` memoized per (atom, element), each call handed a fresh
  copy of the function's own result, so every basis the flax networks
  build is bit for bit the unmemoized one.  A file whose flax EMLP
  networks call it heavily (the critic-128 widths files) takes it with
  ``from torch_jax_fixtures import jax_rho_memo  # noqa: F401``.
- ``jit_bases_as_args``: ``jax.jit`` of a function whose flax EMLP layers
  project their kernels with a large dense basis (``nn.linear_projector``'s
  ``Qw``, 84M entries at critic 128), handing those bases to XLA as
  arguments where jit would embed them as constants (a 2.6 GB float64
  constant: the TD3 update's compile takes ~3 minutes with it, ~20 s
  without).

JAX's persistent compilation cache in a directory fresh for each run and
shared by the xdist workers was measured and left out: the test files
that import ``train.py`` already point every worker at the JAX package's
own cache directory, so a program compiled twice in one run is already
read back, not compiled again.
"""
import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def jax_rho_memo():
    """The JAX package's ``reps.Atom.rho`` memoized per (atom, element) for
    the module: a pure NumPy function that the flax networks' projectors
    call for every atom of a rep (at critic 128 ~33 000 times for a few
    hundred distinct atoms and elements: agent 1's Mirror(1) tower has
    atoms of every rank up to 127, ~2.1M ``np.kron`` calls, ~175 s).  Each
    entry is the function's own result and every call gets a fresh copy
    of it, so every basis JAX builds is bit for bit the unmemoized one."""
    from gym_rotor_tpu.models.emlp import reps as jreps
    orig = jreps.Atom.rho
    memo = {}

    def rho(self, g):
        g = np.asarray(g)
        key = (self, g.shape, g.dtype.str, g.tobytes())
        hit = memo.get(key)
        if hit is None:
            hit = memo[key] = orig(self, g)
        return hit.copy()
    jreps.Atom.rho = rho
    try:
        yield
    finally:
        jreps.Atom.rho = orig


def jit_bases_as_args(fn, static_argnums=(), min_size=1 << 22):
    """``jax.jit(fn, static_argnums=...)`` with every ``Qw`` and ``Qb`` of
    ``nn.linear_projector`` of at least ``min_size`` entries passed to the
    compiled program as an argument (float32, as the projector returns
    them; ``project_linear`` converts them to the kernel's dtype in the
    program) instead of a constant.  The JAX package's code runs as it is:
    only the projector that ``project_linear`` looks up is swapped while
    ``fn`` is traced, to hand back the arguments for the bases the package
    has built and cached (its networks' ``init`` builds them) and the
    package's own result for every other.  XLA then multiplies by a
    parameter where it multiplied by a constant, a different summation
    order: results agree with ``jax.jit(fn)``'s to a few ulps of each
    leaf's largest entry, not bit for bit (at critic 128: 2.5e-15 over a
    TD3 update, 1.8e-16 over a PPO update, against the tests' 1e-9)."""
    import jax
    from gym_rotor_tpu.models.emlp import nn as jnn

    orig = jnn.linear_projector
    live, device = {}, {}

    def projector(rep_in, rep_out):
        out = orig(rep_in, rep_out)
        hit = live.get((hash(rep_in), hash(rep_out)))
        return out if hit is None else hit + out[2:]

    def body(bases, *args):
        live.update(bases)
        jnn.linear_projector = projector
        try:
            return fn(*args)
        finally:
            jnn.linear_projector = orig
            live.clear()

    jitted = jax.jit(body, static_argnums=tuple(i + 1 for i in static_argnums))

    def call(*args):
        for ck, out in list(jnn._LINEAR_PROJ_CACHE.items()):
            if ck not in device and out[0].size >= min_size:
                device[ck] = tuple(jax.device_put(a) for a in out[:2])
        return jitted(dict(device), *args)

    return call
