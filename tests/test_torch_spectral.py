"""K7 (``csrc/spectral.cu``, the spectral-norm regularizer's power
iteration) on the CPU: the kernel's instances against every stack the
learners launch, and a torch emulation of its form and order of summation
against the plain twin and against the JAX package's
``spectral_norm_regularization``.  The form is the two matvecs of each step
(``y = W x``, then ``x = Wᵀ y``), not ``Wᵀ W``.  Row pass: lane c of a row
holds the columns ``4 c + 4 CA g + q``; it sums its products over g with
one accumulator per q, and adds the four as ``(a0 + a1) + (a2 + a3)``; the
column pass adds the row's CA shares in lane order.  ``|x|²`` the same way
from the row lane's columns of x, its CA shares added by a butterfly
(neighbours first).  Column pass: the same sums over the rows ``4 k + 4 RB
g + q`` of a column's RB lanes, added by a butterfly, times ``1 / |x|`` of
the iterate the row pass read (the start vector's too: the direction is
what iterates).  The
last iterate is divided by its norm.  The CUDA kernel
itself is held to the twin by ``chip_smoke.py`` on the card.

Tolerances.  The emulation against the twin: float64 1e-12, float32 1e-5
(unit vectors; the kernel's tolerance against its twin in
``chip_smoke.py``).  The sum of squared norms against JAX's (float32, the
same start vectors): 1e-5 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_rotor_tpu.algos import regularizers as jreg
from gym_rotor_tpu_torch.algos.ppo import PPOAgent
from gym_rotor_tpu_torch.algos.regularizers import (
    spectral_norm_regularization, stack_padded)
from gym_rotor_tpu_torch.algos.sac import SACAgent
from gym_rotor_tpu_torch.algos.td3 import TD3Agent
from gym_rotor_tpu_torch.kernels import spectral as KS
from gym_rotor_tpu_torch.models.emlp.nn import spectral_weights
from gym_rotor_tpu_torch.utils.config import Config

torch.set_num_threads(1)
LEARNERS = tuple((algo, fw) for algo in ("TD3", "SAC", "PPO")
                 for fw in ("MODUL", "MONO", "CTDE"))
AGENT_CLASSES = {"TD3": TD3Agent, "SAC": SACAgent, "PPO": PPOAgent}


@functools.lru_cache(maxsize=None)
def learner_stacks(algo, fw):
    """``(agent, net, weights)`` of every regularized network of a learner
    at full width, seeded: each agent's critic (TD3/SAC twin Q, PPO V) and
    actor, the weights in ``spectral_weights`` order."""
    kw = {"MONO": dict(framework="MONO"),
          "CTDE": dict(module_training="CTDE")}.get(fw, {})
    cfg = Config(rl_algo=algo, **kw)
    gen = torch.Generator().manual_seed(1)
    out = []
    for i in range(cfg.n_agents):
        agent = AGENT_CLASSES[algo](cfg, i, "cpu")
        st = agent.init(gen)
        for net, layout, flat in (("critic", agent.critic_layout, st.critic),
                                  ("actor", agent.actor_layout, st.actor)):
            ws, _ = spectral_weights(layout.views(flat))
            out.append((i, net, [w.detach().clone() for w in ws]))
    return out


def _tree(a):
    """A butterfly's sum over the last axis (neighbours first)."""
    while a.shape[-1] > 1:
        a = a[..., 0::2] + a[..., 1::2]
    return a[..., 0]


def _lane_sums(prod):
    """(..., lanes, groups, 4) products -> (..., lanes): over the groups in
    order with one accumulator per q, then ``(a0 + a1) + (a2 + a3)``."""
    acc = torch.zeros_like(prod[..., 0, :])
    for g in range(prod.shape[-2]):
        acc = acc + prod[..., g, :]
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


def emulate(Ws, x, iters=KS.ITERS):
    """The kernel's iterate ``v`` (K, mi): its instance's padded shape, its
    lanes' pieces of W and its orders of summation."""
    K, mo, mi = Ws.shape
    if iters == 0:
        return x.clone()
    MO, MI, CA, RB, _ = KS.instance(mo, mi)
    W = Ws.new_zeros(K, MO, MI)
    W[:, :mo, :mi] = Ws
    xs = Ws.new_zeros(K, MI)
    xs[:, :mi] = x
    c, g, q = np.meshgrid(np.arange(CA), np.arange(MI // (4 * CA)),
                          np.arange(4), indexing="ij")
    cols = torch.as_tensor(4 * c + 4 * CA * g + q)       # (CA, GA, 4)
    k, g, q = np.meshgrid(np.arange(RB), np.arange(MO // (4 * RB)),
                          np.arange(4), indexing="ij")
    rows = torch.as_tensor(4 * k + 4 * RB * g + q)       # (RB, GB, 4)

    def norm2():            # |x|^2: the row lanes' shares, a butterfly
        return _tree(_lane_sums(xs[:, cols] * xs[:, cols]))
    for _ in range(iters):
        parts = _lane_sums(W[:, :, cols] * xs[:, None][:, :, cols])
        y = parts[..., 0]
        for c in range(1, CA):              # the shares added in order
            y = y + parts[..., c]
        inv = 1.0 / torch.sqrt(norm2())
        Wt = W.transpose(1, 2)
        xs = _tree(_lane_sums(Wt[:, :, rows] * y[:, None][:, :, rows])) \
            * inv[:, None]
    return xs[:, :mi] / torch.sqrt(norm2())[:, None]


def test_instances_cover_every_stack_the_learners_launch():
    """Every regularized network's padded stack has an instance, the
    smallest that holds it; the instances' geometry is the kernel's (a row
    pass of CA lanes and a column pass of RB lanes over the same whole
    warps, both within a warp, whole float4 groups, the staging threads a
    multiple of them, at most 1024); their shared memory fits an H100
    block."""
    for MO, MI, CA, RB, NS in KS.INSTANCES:
        NT = MO * CA
        assert NT == MI * RB and NT % 32 == 0 and NS % NT == 0 and NS <= 1024
        assert CA <= 32 and RB <= 32 and 32 % CA == 0 and 32 % RB == 0
        assert MI % (4 * CA) == 0 and MO % (4 * RB) == 0
        assert KS.smem_bytes(MO, MI) <= 232448
    seen = set()
    for algo, fw in LEARNERS:
        for _, _, ws in learner_stacks(algo, fw):
            Ws, _ = stack_padded(ws, [torch.zeros(w.shape[1]) for w in ws])
            K, mo, mi = Ws.shape
            geo = KS.instance(mo, mi)
            assert geo is not None
            assert geo == min((g for g in KS.INSTANCES
                               if mo <= g[0] and mi <= g[1]),
                              key=lambda g: g[0] * g[2])
            seen.add((K, mo, mi))
    assert {(6, 71, 62), (6, 123, 62), (3, 71, 62), (3, 123, 62),
            (3, 18, 16), (3, 18, 23), (3, 7, 4)} <= seen


def _stack(ws, rng, dtype):
    starts = [torch.as_tensor(rng.normal(size=w.shape[1])) for w in ws]
    Ws, x = stack_padded([w.to(dtype) for w in ws],
                         [s.to(dtype) for s in starts])
    return Ws.contiguous(), x


@pytest.mark.parametrize("learner", LEARNERS, ids="-".join)
def test_kernel_order_matches_plain(learner):
    """The emulation against ``spectral_iterate_plain`` on each of the
    learner's stacks (both agents, critic and actor), from the same start
    vectors: float64 within 1e-12, float32 within 1e-5; ``iters`` 0 returns
    the start vectors."""
    rng = np.random.default_rng(len(learner[0]) + len(learner[1]))
    for i, net, ws in learner_stacks(*learner):
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            Ws, x = _stack(ws, rng, dtype)
            got, ref = emulate(Ws, x), KS.spectral_iterate_plain(Ws, x)
            err = float((got - ref).abs().max())
            assert err <= tol, (i, net, tuple(Ws.shape), dtype, err)
        assert torch.equal(emulate(Ws, x, 0), x)


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 32, 32), (1, 33, 5),
                                   (3, 5, 33), (2, 128, 64), (1, 65, 128),
                                   (2, 128, 128)], ids=str)
def test_kernel_order_at_the_instances_edges(shape):
    """Random stacks at and just past each instance's bounds against the
    twin, float64 within 1e-12 and float32 within 1e-5."""
    K, mo, mi = shape
    rng = np.random.default_rng(mo * 1000 + mi)
    W = rng.normal(0, 0.3, shape)
    x = rng.normal(size=(K, mi))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        Ws = torch.as_tensor(W, dtype=dtype)
        xs = torch.as_tensor(x, dtype=dtype)
        err = float((emulate(Ws, xs) - KS.spectral_iterate_plain(Ws, xs))
                    .abs().max())
        assert err <= tol, (dtype, err)


@pytest.mark.parametrize("learner", LEARNERS, ids="-".join)
def test_kernel_order_matches_jax_regularization(learner):
    """Per network, the sum of squared spectral norms from the emulated
    iterate (``|W v|²`` over the stack) against
    ``gym_rotor_tpu.algos.regularizers.spectral_norm_regularization`` on the
    same weights (float32) with its own start vectors (``fold_in(key, i)``,
    handed to the emulation), within 1e-5 relative; the port's regularizer
    on the CPU (the plain twin) agrees as well."""
    key = jax.random.PRNGKey(3)
    for i, net, ws in learner_stacks(*learner):
        jws = [jnp.asarray(w.numpy(), jnp.float32) for w in ws]
        ref = float(jreg.spectral_norm_regularization(jws, key))
        starts = [torch.as_tensor(np.array(jax.random.normal(
            jax.random.fold_in(key, n), (w.shape[1],), jnp.float32)))
            for n, w in enumerate(ws)]
        Ws, x = stack_padded(ws, starts)
        v = emulate(Ws, x)
        got = float((torch.einsum("kij,kj->ki", Ws, v) ** 2).sum())
        assert abs(got - ref) <= 1e-5 * abs(ref), (i, net, got, ref)
        port = float(spectral_norm_regularization(ws, starts))
        assert abs(port - ref) <= 1e-5 * abs(ref), (i, net, port, ref)
