"""PyTorch port vs the JAX package: EMLP structure, projection, actor
forward (seeded and trained flax params), the folded form (bilinear
nonzeros) the fused actor kernel uses, and equivariance.  Plain twins on the CPU; the CUDA
kernel is held to them by chip_smoke.py on the card."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_rotor_tpu.models.emlp import nn as jnn
from gym_rotor_tpu.models.emlp import zoo as jzoo
from gym_rotor_tpu.utils.checkpoint import load_actor
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch.convert import actor_params_from_jax
from gym_rotor_tpu_torch.kernels import emlp_actor as kactor
from gym_rotor_tpu_torch.kernels.emlp_actor import (emlp_actor,
                                                    emlp_actor_plain,
                                                    fold_actor)
from gym_rotor_tpu_torch.models.emlp import nn as tnn
from gym_rotor_tpu_torch.models.emlp import zoo as tzoo
from gym_rotor_tpu_torch.utils.config import Config as TConfig

torch.set_num_threads(1)
ARTIFACTS = Path(__file__).resolve().parent.parent / "docs" / "artifacts"
AGENTS = [0, 1]


def _np(t):
    return t.detach().cpu().numpy()


def _reps(agent_id, hidden=None):
    cfg = TConfig() if hidden is None else TConfig(actor_hidden_dim=(hidden, hidden))
    return tzoo.actor_reps(cfg, "MODUL", agent_id), \
        jzoo.actor_reps(JConfig(actor_hidden_dim=cfg.actor_hidden_dim), "MODUL",
                        agent_id)


def _flax_actor(agent_id, seed):
    rin, hid, rout = jzoo.actor_reps(JConfig(), "MODUL", agent_id)
    mod = jzoo.EMLPActorDet(rin, hid, rout)
    params = mod.init(jax.random.PRNGKey(seed), jnp.zeros((1, rin.size)))
    return mod, params


def _port_actor(params_np, agent_id, dtype):
    cfg = TConfig()
    rin, hid, rout = tzoo.actor_reps(cfg, "MODUL", agent_id)
    actor = tzoo.EMLPActorDet(rin, hid, rout, device="cpu", dtype=dtype)
    sd = actor_params_from_jax(params_np, cfg, agent_id)
    actor.load_state_dict({k: v.to(dtype) for k, v in sd.items()})
    return actor


def _same(a, b, path="struct"):
    """Deep equality over dicts/lists/tuples/numpy arrays/type groups."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif hasattr(a, "atom_positions"):   # TypeGroup
        assert a.key == b.key and a.mult == b.mult, path
        np.testing.assert_array_equal(a.indices, b.indices, err_msg=path)
        assert a.atom_positions == b.atom_positions, path
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("agent_id,hidden", [(0, None), (1, None), (0, 62),
                                             (1, 62)])
def test_bilinear_struct_matches_jax(agent_id, hidden):
    """Same per-type draws from BILINEAR_SEED, regimes and offsets."""
    (_, thid, _), (_, jhid, _) = _reps(agent_id, hidden)
    tg_t, st_t, w_t = tnn._bilinear_struct(tnn.gated(thid))
    tg_j, st_j, w_j = jnn._bilinear_struct(jnn.gated(jhid))
    assert w_t == w_j
    _same(tg_t, tg_j, "tg")
    _same(st_t, st_j, "st")
    np.testing.assert_array_equal(tnn.gate_indices(thid),
                                  jnn.gate_indices(jhid))


@pytest.mark.parametrize("agent_id", AGENTS)
def test_project_linear_matches_jax(agent_id):
    (trin, thid, trout), (jrin, jhid, jrout) = _reps(agent_id)
    rng = np.random.default_rng(agent_id)
    for (tri, tro), (jri, jro) in [((trin, tnn.gated(thid)), (jrin, jnn.gated(jhid))),
                                   ((thid, tnn.gated(thid)), (jhid, jnn.gated(jhid))),
                                   ((thid, trout), (jhid, jrout))]:
        K = rng.normal(size=(tro.size, tri.size))
        b = rng.normal(size=tro.size)
        for dtype, tol in ((np.float64, 1e-13), (np.float32, 1e-6)):
            Wj, bj = jnn.project_linear(jri, jro, jnp.asarray(K, dtype),
                                        jnp.asarray(b, dtype))
            Wt, bt = tnn.project_linear(tri, tro, torch.from_numpy(K.astype(dtype)),
                                        torch.from_numpy(b.astype(dtype)))
            np.testing.assert_allclose(_np(Wt), np.asarray(Wj), rtol=0, atol=tol)
            np.testing.assert_allclose(_np(bt), np.asarray(bj), rtol=0, atol=tol)


def _check_forward(mod, params, agent_id, seed):
    """Port actor vs flax apply: f64 <= 1e-12, f32 <= 1e-5 (matmul and
    einsum summation orders differ between XLA and torch)."""
    params_np = jax.tree.map(np.asarray, params)
    n_in = jzoo.actor_reps(JConfig(), "MODUL", agent_id)[0].size
    x = np.random.default_rng(seed).normal(0.0, 0.5, size=(64, n_in))
    for dtype, jdt, tol in ((torch.float64, jnp.float64, 1e-12),
                            (torch.float32, jnp.float32, 1e-5)):
        jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params_np)
        ref = np.asarray(mod.apply(jp, jnp.asarray(x, jdt)))
        actor = _port_actor(params_np, agent_id, dtype)
        got = _np(actor(torch.from_numpy(x).to(dtype)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("agent_id", AGENTS)
def test_actor_forward_matches_flax_seeded(agent_id):
    mod, params = _flax_actor(agent_id, seed=10 + agent_id)
    _check_forward(mod, params, agent_id, seed=agent_id)


@pytest.mark.parametrize("agent_id", AGENTS)
def test_actor_forward_matches_flax_trained(agent_id):
    """The repo's trained TD3 MODUL actors (300k steps, seed 1992)."""
    mod, template = _flax_actor(agent_id, seed=0)
    path = ARTIFACTS / f"TD3_MODUL_300.0k_steps_agent_{agent_id}_1992.msgpack"
    params = load_actor(str(path), template)
    _check_forward(mod, params, agent_id, seed=20 + agent_id)


def _sparse_bilinear(o, j, i, v, z):
    """0.1 * sum over nonzeros of v * z_j * z_i, added into output o."""
    return 0.1 * torch.zeros_like(z).index_add_(1, o, v * z[:, j] * z[:, i])


def _kernel_arith(folded, x):
    """The kernel's arithmetic, reading its image at the offsets
    ``csrc/emlp_actor.cu`` gets (``fold_actor``'s layout): per block
    ``W_eff`` transposed and padded, ``b_eff``, the plan's outputs with
    their repacked nonzeros (tile offsets, v) and the gates' tile
    offsets."""
    nin, ng, nh, nact = folded["dims"]
    ngp, P = -(-ng // 4) * 4, kactor.PITCH
    for k, ni in enumerate((nin, nh)):
        Wt = kactor.section(folded, f"wt{k}", ni * ngp).view(ni, ngp)
        b = kactor.section(folded, f"b{k}", ng)
        task = kactor.section(folded, f"task{k}", ng, True).long()
        tptr = kactor.section(folded, f"tptr{k}", ng + 1, True).long()
        nnz = int(tptr[-1])
        ent = kactor.section(folded, f"ent{k}", 2 * nnz, True)
        off, v = ent[0::2].long(), ent.view(Wt.dtype)[1::2]
        o = torch.repeat_interleave(task, tptr.diff())
        lin = x @ Wt[:, :ng] + b
        pre = _sparse_bilinear(o, (off >> 16) // P, (off & 0xFFFF) // P, v,
                               lin) + lin
        gate = kactor.section(folded, f"gate{k}", nh, True).long() // P
        x = torch.sigmoid(pre[:, gate]) * pre[:, :nh]
    Wh = kactor.section(folded, "wh", nact * nh).view(nact, nh)
    return torch.tanh(x @ Wh.T + kactor.section(folded, "bh", nact))


@pytest.mark.parametrize("agent_id", AGENTS)
def test_dense_bilinear_equals_structured(agent_id):
    """The kernel's folded form (W_eff, b_eff, the bilinear nonzeros,
    gates) reproduces the structured network: per layer and, read from the
    packed buffers the kernel gets, for the whole actor, float64."""
    actor = tzoo.make_actors(TConfig(), device="cpu", dtype=torch.float64,
                             seed=3)[agent_id]
    rng = np.random.default_rng(30 + agent_id)
    for blk in actor.network.blocks():
        n = blk.bilinear.rep.size
        z = torch.from_numpy(rng.normal(size=(16, n)))
        o, j, i, v = tnn.bilinear_sparse(blk.bilinear.rep, blk.bilinear.bi_params)
        assert bool((o.diff() >= 0).all()) and v.numel() < n ** 3 // 10
        np.testing.assert_allclose(_np(_sparse_bilinear(o, j, i, v, z)),
                                   _np(blk.bilinear(z)), rtol=0, atol=1e-12)
    x = torch.from_numpy(rng.normal(0.0, 0.5, size=(64, actor.network.block0.rep_in.size)))
    np.testing.assert_allclose(_np(_kernel_arith(fold_actor(actor), x)),
                               _np(emlp_actor_plain(actor, x)), rtol=0,
                               atol=1e-12)


def test_fold_cache_follows_parameters():
    """The cache keys on the actor's explicit ``param_version``: a write in
    place that bumps it refolds, also one through ``.data`` (as a kernel's
    raw-pointer write, invisible to torch's ``_version``); loading a state
    dict or moving the module counts as a write too."""
    actor = tzoo.make_actors(TConfig(), device="cpu", seed=4)[1]
    f1 = fold_actor(actor)
    assert fold_actor(actor) is f1
    with torch.no_grad():
        actor.network.block0.linear.kernel.add_(0.1)
    actor.bump_version()
    f2 = fold_actor(actor)
    assert f2 is not f1
    assert not torch.equal(f1["image"], f2["image"])
    kernel = actor.network.block0.linear.kernel
    seen = kernel._version
    kernel.data.add_(0.1)
    assert kernel._version == seen            # torch saw no write
    actor.bump_version()
    f3 = fold_actor(actor)
    assert f3 is not f2 and not torch.equal(f2["image"], f3["image"])
    actor.load_state_dict(actor.state_dict())
    assert fold_actor(actor) is not f3


@pytest.mark.parametrize("agent_id", AGENTS)
def test_actor_equivariance(agent_id):
    """Pre-tanh port networks are equivariant (< 1e-5, float32)."""
    cfg = TConfig()
    rin, _, rout = tzoo.actor_reps(cfg, "MODUL", agent_id)
    actor = tzoo.make_actors(cfg, device="cpu", seed=5)[agent_id]
    rng = np.random.default_rng(40 + agent_id)
    x = torch.from_numpy(rng.normal(size=(8, rin.size)).astype(np.float32))
    groups = {a.G for a in rin.atoms} | {a.G for a in rout.atoms}
    err = 0.0
    with torch.no_grad():
        y = actor.network(x)
        for grp in groups:
            for g in grp.samples(4, rng):
                ri = torch.from_numpy(rin.rho_dense({grp: g}).astype(np.float32))
                ro = torch.from_numpy(rout.rho_dense({grp: g}).astype(np.float32))
                err = max(err, float((actor.network(x @ ri.T) - y @ ro.T).abs().max()))
    assert err < 1e-5, err


def test_actor_wrapper_uses_plain_on_cpu_and_writes_out():
    cfg = TConfig()
    actors = tzoo.make_actors(cfg, device="cpu", seed=6)
    x0 = torch.randn(5, 15, generator=torch.Generator().manual_seed(0))
    out = torch.zeros(5, 5)
    res = emlp_actor(actors[0], x0, out=out[:, 0:4])
    assert res.data_ptr() == out.data_ptr()
    torch.testing.assert_close(out[:, 0:4], emlp_actor_plain(actors[0], x0),
                               rtol=0, atol=0)
    assert torch.all(out[:, 4] == 0)
