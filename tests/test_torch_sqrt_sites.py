"""The plain path's float32 roots against the JAX functions, bit for bit,
on inputs whose roots torch's CPU float32 ``sqrt`` rounds wrongly on some
hosts (numpy's and XLA's ``sqrt`` are correctly rounded): each site now
takes its root through ``ops/so3.py::sqrt_rn``.

- ``kernels/gae.py::normalize_plain``: the advantages' std, held to the
  normalisation of ``gym_rotor_tpu/algos/ppo.py:119-146`` ``gae`` (fed
  zero values and dones, so its advantages are the rewards);
- ``kernels/flat_adamw.py::flat_adamw_plain``: the clip's norm and
  ``sqrt(nu / bc2)`` (two cases), held to the JAX package's optax chain
  (``algos/common.py::make_optimizer``, clip by global norm -> adamw);
- ``algos/sac.py::ScalarAdamW``: the temperature's ``sqrt(nu / bc2)``,
  held to ``optax.adamw`` on ``log_alpha`` (``gym_rotor_tpu/algos/sac.py``).

Every input is a multiple of a power of two small enough that every sum
and product before the root is exact in float32, so the functions agree
bit for bit where their roots do.  The seeds are inputs on which the
port's function, its root taken by ``torch.sqrt`` as before the repair,
answers otherwise than with ``sqrt_rn`` on a CPU whose ``torch.sqrt``
misrounds (an AMD EPYC: the root's module attribute ``sqrt_rn`` set to
``torch.sqrt`` changes the answer on each); on a host whose ``torch.sqrt``
rounds correctly they are ordinary inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gym_rotor_tpu.algos import common as jcommon
from gym_rotor_tpu.algos import ppo as jppo
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch.algos import common as tcommon
from gym_rotor_tpu_torch.algos import sac as tsac
from gym_rotor_tpu_torch.kernels import flat_adamw as K6
from gym_rotor_tpu_torch.kernels import gae as K12
from gym_rotor_tpu_torch.utils.config import Config as TConfig

jax.config.update("jax_platforms", "cpu")
LR = 3e-4


def _grid(rng, shape, scale=2.0 ** -6):
    """Small integers times ``scale``: sums of a few hundred squares stay
    exact in float32."""
    return (rng.integers(-64, 65, shape) * scale).astype(np.float32)


def _normalize_port(adv):
    return K12.normalize_plain(torch.from_numpy(adv)).numpy()


def _normalize_jax(adv):
    zero = jnp.zeros(adv.shape, jnp.float32)
    return np.asarray(jppo.gae(JConfig(), zero, zero, jnp.asarray(adv),
                               zero + 1.0)[0])


def _adamw_port(gs, p0):
    ttx = tcommon.make_optimizer(TConfig(), LR)
    tp = torch.from_numpy(p0.copy())
    topt = ttx.init(tp)
    for g in gs:
        K6.flat_adamw_plain(tp, torch.from_numpy(g), topt.mu, topt.nu,
                            ttx.scalars(topt))
        topt = tcommon.OptState(topt.count + 1, topt.mu, topt.nu,
                                topt.sched_count + 1)
    return np.concatenate([tp.numpy(), topt.mu.numpy(), topt.nu.numpy()])


def _adamw_jax(gs, p0):
    jtx = jcommon.make_optimizer(JConfig(), LR)
    jp = jnp.asarray(p0)
    jopt = jtx.init(jp)
    for g in gs:
        upd, jopt = jtx.update(jnp.asarray(g), jopt, jp)
        jp = optax.apply_updates(jp, upd)
    adam = jopt[1][0]
    return np.concatenate([np.asarray(jp), np.asarray(adam.mu),
                           np.asarray(adam.nu)])


def _adamw_make(clipped: bool):
    """Two steps' gradients: the first's norm far past the clip of 100
    (``clipped``) or both under it."""
    return lambda rng: np.stack([_grid(rng, 37, 8.0 if clipped else 2.0 ** -4),
                                 _grid(rng, 37, 2.0 ** -4)])


P0 = _grid(np.random.default_rng(7), 37)


def _temperature_make(rng):
    return (rng.integers(1, 4096, 3) * 2.0 ** -10).astype(np.float32)


def _temperature_port(gs):
    ttx = tsac.ScalarAdamW(LR)
    tl = torch.zeros((), dtype=torch.float32)
    topt, out = ttx.init(tl), []
    for g in gs:
        tl, topt = ttx.update(tl, torch.tensor(g), topt)
        out.append(tl.numpy())
    return np.stack(out)


def _temperature_jax(gs):
    jtx = optax.adamw(LR)
    jl = jnp.zeros((), jnp.float32)
    jopt, out = jtx.init(jl), []
    for g in gs:
        upd, jopt = jtx.update(jnp.asarray(g), jopt, jl)
        jl = optax.apply_updates(jl, upd)
        out.append(np.asarray(jl))
    return np.stack(out)


# per site: (inputs from a seed, the port's function, the JAX function,
# seeds); the clip's case takes one step, so its norm decides
SITES = {
    "gae_normalize": (lambda rng: _grid(rng, (8, 8)), _normalize_port,
                      _normalize_jax, (18, 22, 39)),
    "flat_adamw_norm": (_adamw_make(True), lambda gs: _adamw_port(gs[:1], P0),
                        lambda gs: _adamw_jax(gs[:1], P0), (4, 7, 8)),
    "flat_adamw_moment": (_adamw_make(False), lambda gs: _adamw_port(gs, P0),
                          lambda gs: _adamw_jax(gs, P0), (17, 35, 45)),
    "sac_temperature": (_temperature_make, _temperature_port,
                        _temperature_jax, (10, 25, 32)),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_float32_roots_bitwise_jax(site):
    """The plain function bit for bit the JAX one at each repaired root:
    ``normalize_plain``'s std; ``flat_adamw_plain``'s clip norm (one
    clipped step) and its ``sqrt(nu / bc2)`` (two unclipped steps); the
    temperature's ``sqrt(nu / bc2)`` over three steps."""
    make, port, ref, seeds = SITES[site]
    for seed in seeds:
        x = make(np.random.default_rng(seed))
        got, want = port(x), ref(x)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), \
            f"{site} seed {seed}: {np.max(np.abs(got - want))} max abs"
