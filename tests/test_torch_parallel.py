"""The port over a ``torch.distributed`` process group vs the JAX package
over a 2-device mesh: GAE's normalisation over the ranks, the sharded
TD3, SAC and PPO supersteps rank by rank, and the driver, checkpoints and
resume over the group.

The port runs in subprocesses (``torch_parallel_worker.py``), one a rank,
in a ``gloo`` group on the CPU that meets through a ``FileStore`` in the
test's ``tmp_path`` (no TCP port: test files run side by side); they
import torch and the port only.  This process runs JAX on
``make_mesh(2)`` of ``conftest.py``'s virtual devices and gives each rank
its device's shard and draws: the superstep key folded with the device
index (``fold_in(key, d)``, ``train_step.py:103``, ``:245``), then the
splits of ``test_torch_td3.py::superstep_vs_jax`` and
``test_torch_ppo.py::ppo_superstep_vs_jax``.  Rank ``d`` is held to JAX's
device ``d``: its envs, ring rows and ``ep_ret`` shard, the replicated
parameters (SAC's ``log_alpha`` is each device's own: ``sac.py:264-271``
reduces no temperature gradient) and the reduced metrics, at those
files' float32 tolerances (GAE in float64 at ``test_torch_ppo.py``'s
1e-12).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from gym_rotor_tpu.algos import ppo as jppo
from gym_rotor_tpu.envs import batch as jbatch
from gym_rotor_tpu.models import zoo as jmodels
from gym_rotor_tpu.parallel import mesh as jmesh
from gym_rotor_tpu.parallel.train_step import (init_ep_ret,
                                               make_sharded_ppo_superstep,
                                               make_sharded_td3_superstep,
                                               sharded_init)
from gym_rotor_tpu_torch.algos import ppo as tppo
from gym_rotor_tpu_torch.algos.sac import ScalarAdamW
from gym_rotor_tpu_torch.envs import draws as D
from gym_rotor_tpu_torch.ops.so3 import sqrt_rn
from gym_rotor_tpu_torch.parallel import mesh as tmesh
from gym_rotor_tpu_torch.train import Learner
from gym_rotor_tpu_torch.utils import checkpoint as tckpt
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from gym_rotor_tpu_torch.utils.tree import tree_named_leaves
import torch_parallel_worker as W
from test_torch_env import _tick_draws
from test_torch_ppo import PPO, _compare_ppo, _epoch_draws, _ppo_cfgs
from test_torch_sac import SAC
from test_torch_td3 import (NARROW, TD3, _cfgs, _close, _np, _np_tree,
                            _policy_arrays, _t)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
WORLD = 2
TIMEOUT = 300          # seconds a rank may take: no hang eats the suite's
TINY = dict(num_envs=8, start_timesteps=16, batch_size=16,
            critic_hidden_dim=8, actor_hidden_dim=(4, 2),
            replay_buffer_size=64)
TINY_PPO = dict(TINY, rl_algo="PPO", num_envs=4, T_horizon=16,
                actor_batch_size=4, critic_batch_size=4, K_epochs=2)


def run_ranks(tmp_path, fn, world=WORLD, **kw):
    """``torch_parallel_worker.fn(mesh, **kw)`` on ``world`` ranks of a
    ``gloo`` group; their results in rank order."""
    tag = f"{fn}-{len(list(tmp_path.glob('*.job')))}"
    job = tmp_path / f"{tag}.job"
    torch.save({"fn": fn, "kw": kw}, job)
    outs = [tmp_path / f"{tag}.{r}.out" for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(job), str(r), str(world),
         str(tmp_path / f"{tag}.store"), str(outs[r])], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" \
            f"{text[-4000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


def _device_view(tree, mesh, d):
    """Device ``d``'s buffers of the (replicated) arrays in ``tree``: its
    own ``log_alpha``, which JAX's ``P()`` out-spec does not reconcile."""
    dev = list(mesh.devices.flat)[d]

    def one(x):
        if isinstance(x, jax.Array) and len(x.sharding.device_set) > 1:
            return next(s.data for s in x.addressable_shards
                        if s.device == dev)
        return x
    return jax.tree.map(one, tree)


def _rows(tree, sl):
    """Rows ``sl`` of every array of a nested dict."""
    if isinstance(tree, dict):
        return {k: _rows(v, sl) for k, v in tree.items()}
    return np.asarray(tree)[sl]


# ---------------------------------------------------------------------------
# GAE: K12's sharded route (its plain twin) vs JAX's gae under shard_map
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,nb", [(9, 6), (1, 2)])
def test_gae_sharded_matches_jax(T, nb, tmp_path):
    """``gae(..., axis_name)`` in a ``shard_map`` over 2 devices, env
    columns sharded, vs ``kernels/gae.py::gae_sharded`` on each rank's
    columns (``gae_sharded_plain`` on the CPU): each rank's advantages
    and TD targets within 1e-12 of its device's, float64; the
    normalisation over both ranks' entries."""
    jcfg, _ = _ppo_cfgs()
    rng = np.random.default_rng(3 + T)
    v, nv, r = (rng.normal(size=(T, nb, 1)) for _ in range(3))
    d = (rng.uniform(size=(T, nb, 1)) < 0.2).astype(np.float64)
    mesh = jmesh.make_mesh(WORLD)
    spec = P(None, jcfg.mesh_axis)
    fn = jax.jit(shard_map(
        lambda *x: jppo.gae(jcfg, *x, axis_name=jcfg.mesh_axis), mesh=mesh,
        in_specs=(spec,) * 4, out_specs=(spec, spec), check_vma=False))
    jadv, jtd = (np.asarray(x) for x in fn(*map(jnp.asarray, (v, nv, r, d))))
    half = nb // WORLD
    cols = [slice(k * half, (k + 1) * half) for k in range(WORLD)]
    out = run_ranks(tmp_path, "gae",
                    inputs=[[x[:, c] for x in (v, nv, r, d)] for c in cols],
                    gamma=jcfg.discount, lam=jcfg.GAE_lambda)
    for (adv, td), c in zip(out, cols):
        assert adv.dtype == torch.float64
        _close(_np(adv), jadv[:, c], 1e-12, "advantages")
        _close(_np(td), jtd[:, c], 1e-12, "td targets")
    both = np.concatenate([_np(a) for a, _ in out], axis=1)
    assert abs(both.mean()) < 1e-12
    if both.size > 1:
        assert abs(both.std(ddof=1) - 1.0) < 1e-3


# ---------------------------------------------------------------------------
# Sharded supersteps, rank by rank
# ---------------------------------------------------------------------------
def sharded_offpolicy_vs_jax(tmp_path, algo, supersteps=(2, 3), **cfg_kw):
    """``supersteps`` warm then train off-policy supersteps (one tick, one
    update) of ``make_sharded_td3_superstep`` on a 2-device mesh against
    the port's ``make_td3_superstep(mesh=...)`` on 2 ranks: each rank from
    its device's envs, ring rows and states, with its device's draws
    (local batch ``batch_size / 2``), held to its device's shard after
    every superstep.  Returns each rank's snapshots."""
    kw = dict(num_envs=8, replay_buffer_size=28, max_steps=3, **cfg_kw)
    jcfg, tcfg = _cfgs(**kw)
    n = jcfg.n_agents
    B, C = jcfg.num_envs // WORLD, jcfg.replay_buffer_size // WORLD
    lb = max(jcfg.batch_size // WORLD, 1)
    rows = [slice(k * B, (k + 1) * B) for k in range(WORLD)]
    mesh = jmesh.make_mesh(WORLD)
    jagents = [algo.jax_agent(jcfg, i) for i in range(n)]
    jstates = [jax.device_put(a.init(jax.random.PRNGKey(60 + i)),
                              jmesh.replicated(mesh))
               for i, a in enumerate(jagents)]
    jbs, jobs, jrs = sharded_init(jcfg, mesh, jax.random.PRNGKey(61))
    jep = init_ep_ret(jcfg, mesh)
    jstep = make_sharded_td3_superstep(jcfg, jagents, mesh, rollout_len=1,
                                       n_updates=1,
                                       **algo.jax_hooks(jagents))
    tagents = [algo.port_agent(tcfg, i) for i in range(n)]
    per_rank = [dict(
        states=[_np_tree(_device_view(s, mesh, d)) for s in jstates],
        env=_rows(_np_tree(jbs), rows[d]),
        obs=[np.asarray(o)[rows[d]] for o in jobs],
        ring=dict(data=np.asarray(jrs.data)[d * C:(d + 1) * C],
                  ptr=int(jrs.ptr), filled=int(jrs.filled)),
        steps=[]) for d in range(WORLD)]
    draws_fn = jax.jit(lambda b: _tick_draws(b, jnp.float32))
    act_dims = tuple(jcfg.action_dim_n)
    ref = []
    for s in range(sum(supersteps)):
        warm = s < supersteps[0]
        key = jax.random.PRNGKey(70 + s)
        k_upd = []
        for d in range(WORLD):
            k_roll, ku = jax.random.split(jax.random.fold_in(key, d))
            k_upd.append(ku)
            _, sub = jax.random.split(k_roll)
            policy = _policy_arrays(sub, B, act_dims, warm)
            env = _t(draws_fn(jax.tree.map(lambda x: x[rows[d]], jbs)))
            tick = D.TickDraws(env, _t(policy) if warm
                               else tuple(map(_t, policy)))
            per_rank[d]["steps"].append((warm, ([tick], [])))
        jbs, jobs, jrs, jstates, jep, jm = jstep(jbs, jobs, jrs, jstates, jep,
                                                  key, 0.3, warm=warm)
        for d in range(WORLD):
            if warm:
                continue
            (ku,) = jax.random.split(k_upd[d], 1)
            k_s, k_u = jax.random.split(ku)
            idx = jax.random.randint(k_s, (lb,), 0,
                                     jnp.maximum(jrs.filled, 1))
            per_rank[d]["steps"][-1][1][1].append(D.UpdateDraws(
                _t(idx).long(), algo.draws(k_u, tagents, lb, torch.float32,
                                           jnp.float32)))
        ref.append(dict(obs=[np.asarray(o) for o in jobs],
                        ring=np.asarray(jrs.data), ptr=int(jrs.ptr),
                        filled=int(jrs.filled), ep=np.asarray(jep),
                        metrics={k: np.asarray(v) for k, v in jm.items()},
                        states=[[_device_view(st, mesh, d) for st in jstates]
                                for d in range(WORLD)]))
    out = run_ranks(tmp_path, "superstep",
                    algo="SAC" if algo is SAC else "TD3",
                    cfg_kw={**NARROW, **kw}, per_rank=per_rank)
    resets = 0
    for s, j in enumerate(ref):
        for d in range(WORLD):
            t, what = out[d][s], f"superstep {s} rank {d}"
            for a, b in zip(t["obs"], j["obs"]):
                np.testing.assert_allclose(_np(a), b[rows[d]], rtol=2e-5,
                                           atol=2e-6, err_msg=what)
            data, ptr, filled = t["ring"]
            np.testing.assert_allclose(_np(data), j["ring"][d * C:(d + 1) * C],
                                       rtol=2e-5, atol=2e-6, err_msg=what)
            assert (ptr, filled) == (j["ptr"], j["filled"])
            np.testing.assert_allclose(_np(t["ep_ret"]), j["ep"][rows[d]],
                                       rtol=1e-5, atol=1e-5, err_msg=what)
            tm, jm = t["metrics"], j["metrics"]
            assert set(tm) == set(jm)
            np.testing.assert_allclose(float(tm["mean_reward"]),
                                       float(jm["mean_reward"]), rtol=1e-5)
            np.testing.assert_allclose(_np(tm["fin_sum"]), jm["fin_sum"],
                                       rtol=1e-5, atol=1e-5)
            assert float(tm["fin_cnt"]) == float(jm["fin_cnt"])
            if s >= supersteps[0]:
                for i in range(n):
                    for k in algo.losses:
                        np.testing.assert_allclose(
                            float(tm[f"agent{i}/{k}"]),
                            float(jm[f"agent{i}/{k}"]), rtol=1e-4, atol=1e-7,
                            err_msg=f"{what} agent {i} {k}")
                    algo.compare(t["states"][i], j["states"][d][i], algo.rel,
                                 f"{what} agent {i}")
        resets += int(j["metrics"]["fin_cnt"])
    assert resets > 0
    return out


def test_sharded_td3_superstep_matches_jax(tmp_path):
    """TD3 (MODUL, DTDE, EMLP, narrow widths): 2 warm + 3 train supersteps
    over 2 ranks, each rank its device's shard; the replicated parameters
    bitwise equal on both ranks after every superstep."""
    out = sharded_offpolicy_vs_jax(tmp_path, TD3)
    for a, b in zip(*out):
        for sa, sb in zip(a["states"], b["states"]):
            for name in ("actor", "critic", "actor_target", "critic_target"):
                assert torch.equal(getattr(sa, name), getattr(sb, name))
            assert torch.equal(sa.critic_opt.nu, sb.critic_opt.nu)


def test_sharded_sac_superstep_matches_jax(tmp_path):
    """SAC with the temperature tuned, over 2 ranks: each rank's
    ``log_alpha`` and its Adam moments its own device's (JAX reduces no
    temperature gradient, so the two differ), the networks replicated."""
    out = sharded_offpolicy_vs_jax(tmp_path, SAC,
                                   automatic_entropy_tuning=True)
    last = [o[-1]["states"][0] for o in out]
    assert torch.equal(last[0].actor, last[1].actor)
    assert not torch.equal(last[0].log_alpha, last[1].log_alpha)


def test_sharded_ppo_superstep_matches_jax(tmp_path):
    """PPO over 2 ranks against ``make_sharded_ppo_superstep``: 2
    supersteps of one horizon each, each rank's 2 envs over 4 ticks with
    its device's acting noise and epoch draws (minibatches of
    ``actor_batch_size`` rows of its own horizon), GAE normalised over
    both; losses 1e-4 relative, states 1e-4 of the largest entry, as
    ``test_torch_ppo.py``."""
    jcfg, tcfg = _ppo_cfgs(max_steps=3)
    n, B = jcfg.n_agents, jcfg.num_envs // WORLD
    rows = [slice(k * B, (k + 1) * B) for k in range(WORLD)]
    mesh = jmesh.make_mesh(WORLD)
    jagents = [jppo.PPOAgent(jcfg, i, jmodels.ppo_models(jcfg, i))
               for i in range(n)]
    jstates = [jax.device_put(a.init(jax.random.PRNGKey(60 + i)),
                              jmesh.replicated(mesh))
               for i, a in enumerate(jagents)]
    jbs, jobs, _ = sharded_init(jcfg, mesh, jax.random.PRNGKey(61),
                                with_replay=False)
    jep = init_ep_ret(jcfg, mesh)
    rl = jcfg.T_horizon // jcfg.num_envs
    jstep = make_sharded_ppo_superstep(jcfg, jagents, mesh, rollout_len=rl)
    tagents = [tppo.PPOAgent(tcfg, i, "cpu") for i in range(n)]
    draws_fn = jax.jit(lambda b: _tick_draws(b, jnp.float32))

    @jax.jit
    def replay_tick(bs, ob, states, k):
        """One tick of the superstep's scan body on one device's envs:
        the acting noise and the next env state (train_step.py:252-264)."""
        acts, noise = [], []
        for i, a in enumerate(jagents):
            k, sub = jax.random.split(k)
            act, _ = a.choose_action_f(a.fold_actor(states[i].actor), ob[i],
                                       sub)
            acts.append(act)
            noise.append(jax.random.normal(sub, act.shape))
        bs, out = jbatch.batched_step(jcfg, bs, jnp.concatenate(acts, -1))
        return bs, out.obs, tuple(noise)

    per_rank = [dict(
        states=[_np_tree(_device_view(s, mesh, d)) for s in jstates],
        env=_rows(_np_tree(jbs), rows[d]),
        obs=[np.asarray(o)[rows[d]] for o in jobs], steps=[])
        for d in range(WORLD)]
    ref = []
    for s in range(2):
        key = jax.random.PRNGKey(70 + s)
        for d in range(WORLD):
            k_roll, k_upd = jax.random.split(jax.random.fold_in(key, d))
            # device d's envs and states as arrays of one device
            bs, ob, st = jax.tree.map(
                lambda x: jnp.asarray(np.asarray(x)),
                (jax.tree.map(lambda x: x[rows[d]], jbs),
                 tuple(o[rows[d]] for o in jobs),
                 [_device_view(x, mesh, d) for x in jstates]))
            ticks = []
            for k in jax.random.split(k_roll, rl):
                env = _t(draws_fn(bs))
                bs, ob, noise = replay_tick(bs, ob, st, k)
                ticks.append(D.TickDraws(env, tuple(_t(x, torch.float32)
                                                    for x in noise)))
            epochs = _epoch_draws(k_upd, tagents, rl * B, jcfg.K_epochs,
                                  torch.float32, jnp.float32)
            per_rank[d]["steps"].append((False, (ticks, epochs)))
        jbs, jobs, jstates, jep, jm = jstep(jbs, jobs, jstates, jep, key)
        ref.append(dict(obs=[np.asarray(o) for o in jobs], ep=np.asarray(jep),
                        metrics={k: np.asarray(v) for k, v in jm.items()},
                        states=list(jstates)))
    out = run_ranks(tmp_path, "superstep", algo="PPO",
                    cfg_kw={**NARROW, **PPO, "max_steps": 3},
                    per_rank=per_rank, rollout_len=rl)
    resets = 0
    for s, j in enumerate(ref):
        for d in range(WORLD):
            t, what = out[d][s], f"superstep {s} rank {d}"
            for a, b in zip(t["obs"], j["obs"]):
                np.testing.assert_allclose(_np(a), b[rows[d]], rtol=2e-5,
                                           atol=2e-6, err_msg=what)
            np.testing.assert_allclose(_np(t["ep_ret"]), j["ep"][rows[d]],
                                       rtol=1e-5, atol=1e-5, err_msg=what)
            tm, jm = t["metrics"], j["metrics"]
            assert set(tm) == set(jm)
            np.testing.assert_allclose(float(tm["mean_reward"]),
                                       float(jm["mean_reward"]), rtol=1e-5)
            np.testing.assert_allclose(_np(tm["fin_sum"]), jm["fin_sum"],
                                       rtol=1e-5, atol=1e-5)
            assert float(tm["fin_cnt"]) == float(jm["fin_cnt"])
            for i in range(n):
                for k in ("actor_loss", "critic_loss"):
                    np.testing.assert_allclose(
                        float(tm[f"agent{i}/{k}"]), float(jm[f"agent{i}/{k}"]),
                        rtol=1e-4, atol=1e-7, err_msg=f"{what} agent {i} {k}")
                _compare_ppo(t["states"][i], j["states"][i], 1e-4,
                             f"{what} agent {i}")
                assert torch.equal(t["states"][i].actor,
                                   out[1 - d][s]["states"][i].actor)
        resets += int(j["metrics"]["fin_cnt"])
    assert resets > 0


# ---------------------------------------------------------------------------
# The learner and the driver over the group
# ---------------------------------------------------------------------------
def _bitwise(x, y, what):
    if isinstance(x, torch.Tensor):
        assert isinstance(y, torch.Tensor) and x.dtype == y.dtype \
            and x.shape == y.shape, what
        assert x.numpy().tobytes() == y.numpy().tobytes(), what
    elif isinstance(x, dict):
        assert set(x) == set(y), what
        for k in x:
            _bitwise(x[k], y[k], f"{what}.{k}")
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y), what
        for i, (p, q) in enumerate(zip(x, y)):
            _bitwise(p, q, f"{what}[{i}]")
    elif hasattr(x, "__dataclass_fields__"):
        for f in x.__dataclass_fields__:
            _bitwise(getattr(x, f), getattr(y, f), f"{what}.{f}")
    else:
        assert type(x) is type(y) and x == y, what


def _own_temperatures(ranks, cfg, prev):
    """Each rank's temperature is its own, as JAX's per-device step
    (``sac.py:264-271``) leaves it: every agent's Adam moments ``mu`` and
    ``nu`` differ across the ranks (each its own gradient), and each
    rank's ``log_alpha`` is the Adam step from its previous value
    (``prev``'s, or the initial 0) with its own saved moments, in
    ``ScalarAdamW``'s order.  ``log_alpha`` itself may agree across the
    ranks: Adam's first step is ``lr * sign(g)`` up to the rounding of
    ``mu_hat / (sqrt(nu_hat) + eps)``, which is 1 to within an ulp."""
    tx = ScalarAdamW
    for i in range(len(ranks[0])):
        sts = [r[i] for r in ranks]
        for f in ("mu", "nu"):
            vals = [getattr(st.alpha_opt, f) for st in sts]
            assert not any(torch.equal(vals[0], v) for v in vals[1:]), \
                f"agent {i} alpha_opt.{f} equal across ranks"
        for r, st in enumerate(sts):
            o = st.alpha_opt
            p = (torch.zeros((), dtype=torch.float32) if prev is None
                 else prev[r][i].log_alpha)
            assert o.count == st.total_it
            u = (o.mu / (1 - tx.b1 ** o.count)) / (
                sqrt_rn(o.nu / (1 - tx.b2 ** o.count)) + tx.eps)
            want = p + (-cfg.lr_a[i]) * (u + tx.wd * p)
            _bitwise(st.log_alpha, want, f"rank {r} agent {i} log_alpha")


@pytest.mark.parametrize("algo", ["TD3", "PPO"])
def test_world1_group_is_the_one_device_path(algo, tmp_path):
    """A ``gloo`` group of one rank: ``Learner`` over it, superstep by
    superstep, bitwise the learner without a process group (states,
    generators, ring, env state, observations, ``ep_ret``, metrics)."""
    kw = TINY_PPO if algo == "PPO" else dict(TINY, rl_algo=algo)
    (got,) = run_ranks(tmp_path, "train", world=1, cfg_kw=kw, supersteps=4)
    learner = Learner(TConfig(**kw), device="cpu")
    assert learner.mesh.world == 1 and learner.mesh.group is None
    for s, g in enumerate(got):
        _, metrics, _ = learner.superstep()
        want = W.snapshot(learner)
        want["metrics"] = metrics
        _bitwise(g, want, f"superstep {s}")


@pytest.mark.parametrize("algo", ["TD3", "SAC", "PPO"])
def test_parameters_stay_replicated(algo, tmp_path):
    """``Learner`` on 2 ranks for 3 supersteps (TD3/SAC: 2 warm, then
    train): every agent's parameters, targets and optimizer moments
    bitwise equal on both ranks after each superstep (SAC's temperature
    apart), the reduced metrics equal, the envs and rings each rank's
    own; each rank a ring of ``replay_buffer_size / 2`` rows."""
    kw = TINY_PPO if algo == "PPO" else dict(TINY, rl_algo=algo)
    if algo == "SAC":
        kw["automatic_entropy_tuning"] = True
    a, b = run_ranks(tmp_path, "train", cfg_kw=kw, supersteps=3)
    for s, (x, y) in enumerate(zip(a, b)):
        for sx, sy in zip(x["states"], y["states"]):
            for name in ("actor", "critic", "actor_opt", "critic_opt",
                         "actor_target", "critic_target", "total_it"):
                if hasattr(sx, name):
                    _bitwise(getattr(sx, name), getattr(sy, name),
                             f"superstep {s} {name}")
        _bitwise(x["metrics"], y["metrics"], f"superstep {s} metrics")
        assert not torch.equal(x["obs"][0], y["obs"][0])
        if algo != "PPO":
            assert x["ring"][0].shape[0] == kw["replay_buffer_size"] // 2
        assert x["ep_ret"].shape[0] == kw["num_envs"] // 2
    if algo == "SAC":
        _own_temperatures([x[-1]["states"] for x in (a, b)],
                          TConfig(**kw), prev=None)


def test_ranks_reset_the_global_batch(monkeypatch):
    """Every rank resets the same global env batch from ``cfg.seed`` and
    keeps its rows: a learner of rank ``r`` of 2 (a ``Mesh`` without a
    group, the parameters' broadcast skipped: the same seed makes them
    equal) starts from rows ``[r B/2, (r + 1) B/2)`` of the one-device
    learner's envs; rank 0 goes on with the seed's generator, rank 1 with
    its own."""
    cfg = TConfig(**TINY)
    one = Learner(cfg, device="cpu")
    full = dict(tree_named_leaves(one.loop.state))
    monkeypatch.setattr(tmesh, "replicate", lambda tensors, mesh: tensors)
    for r in range(WORLD):
        mesh = tmesh.Mesh(r, WORLD, torch.device("cpu"))
        part = Learner(cfg, device="cpu", mesh=mesh)
        sl = mesh.rows(cfg.num_envs)
        for k, v in tree_named_leaves(part.loop.state):
            assert torch.equal(v, full[k][sl]), k
        for o, p in zip(one.obs, part.obs):
            assert torch.equal(p, o[sl])
        same = torch.equal(part.gen.get_state(), one.gen.get_state())
        assert same == (r == 0)
    assert tmesh.rank_seed(cfg.seed, 0) == cfg.seed
    assert len({tmesh.rank_seed(cfg.seed, r) for r in range(8)}) == 8


def test_main_on_two_ranks_writes_rank0_files(tmp_path):
    """``main(argv, device="cpu")`` on 2 ranks: one eval log, the actor
    files and the checkpoint written once (rank 0), the ring in the file
    the ranks' rings concatenated in rank order, each rank's generators
    and env rows in ``mesh``; the parameters equal on both ranks."""
    ck = tmp_path / "ck" / "ts.msgpack"
    argv = ["--num_envs", "8", "--max_steps", "16", "--eval_max_steps", "1",
            "--num_eval", "4", "--seed", "7", "--replay_buffer_size", "128",
            "--batch_size", "16", "--critic_hidden_dim", "8",
            "--actor_hidden_dim", "8", "4", "--framework", "MONO",
            "--use_equiv", "False", "--checkpoint_path", str(ck),
            "--max_timesteps", "64", "--start_timesteps", "32",
            "--eval_freq", "16", "--checkpoint_freq", "32",
            "--checkpoint_replay", "True"]
    a, b = run_ranks(tmp_path, "run_main", argv=argv, cwd=str(tmp_path))
    assert (tmp_path / "results").is_dir()
    assert len(list((tmp_path / "results").glob("log_eval_seed_7*"))) == 1
    evals = (next((tmp_path / "results").glob("log_eval_seed_7*"))
             .read_text().strip().splitlines())
    assert len(evals) == 3               # t = 40, 48, 64 (16 a superstep)
    assert list((tmp_path / "models").glob("TD3_MONO_*agent_0*_7.msgpack"))
    tree = tckpt.read_train_state(str(ck))
    assert tree["mesh"]["world"] == WORLD
    ring = np.concatenate([_np(x["ring"][0]) for x in (a, b)])
    np.testing.assert_array_equal(tree["replay"]["data"], ring)
    assert tree["replay"]["ptr"] == a["ring"][1] == b["ring"][1]
    for r, x in enumerate((a, b)):
        saved = tree["mesh"]["ranks"][r]["generators"]
        np.testing.assert_array_equal(saved["env"], _np(x["gen"]))
    np.testing.assert_array_equal(
        tree["mesh"]["ep_ret"],
        np.concatenate([_np(x["ep_ret"]) for x in (a, b)]))
    for sa, sb in zip(a["states"], b["states"]):
        _bitwise(sa.actor, sb.actor, "actor")


@pytest.mark.parametrize("algo", ["TD3", "SAC"])
def test_resume_on_two_ranks_is_bitwise(algo, tmp_path):
    """2 ranks: checkpoint after 3 supersteps with the ring, load into
    fresh learners: every rank's states (SAC's own temperature),
    generators, ring, env state, observations and ``ep_ret`` bitwise the
    saved learner's; one more superstep on each bitwise alike."""
    kw = dict(TINY, rl_algo=algo, checkpoint_replay=True)
    if algo == "SAC":
        kw["automatic_entropy_tuning"] = True
    out = run_ranks(tmp_path, "resume", cfg_kw=kw, supersteps=3,
                    path=str(tmp_path / "ts.msgpack"))
    for r, (at_load, after) in enumerate(out):
        _bitwise(at_load[0], at_load[1], f"rank {r} at load")
        _bitwise(after[0], after[1], f"rank {r} one superstep on")
    if algo == "SAC":
        cfg = TConfig(**kw)
        loaded = [o[0][0]["states"] for o in out]
        _own_temperatures(loaded, cfg, prev=None)
        _own_temperatures([o[1][0]["states"] for o in out], cfg, prev=loaded)


def test_resume_at_another_world_size_raises(tmp_path):
    """A checkpoint saved by 2 ranks does not load at world 1, nor one
    saved at world 1 on 2 ranks: ``ValueError`` naming both sizes."""
    kw = dict(TINY, checkpoint_replay=True)
    two = str(tmp_path / "two.msgpack")
    run_ranks(tmp_path, "resume", cfg_kw=kw, supersteps=2, path=two)
    with pytest.raises(ValueError, match="world of 2 rank.*has 1"):
        Learner(TConfig(**kw), device="cpu").load_checkpoint(two)
    one = str(tmp_path / "one.msgpack")
    learner = Learner(TConfig(**kw), device="cpu")
    learner.superstep()
    learner.save_checkpoint(one)
    assert "mesh" not in tckpt.read_train_state(one)
    errs = run_ranks(tmp_path, "load", cfg_kw=kw, path=one)
    assert all(e and "world of 1 rank" in e and "has 2" in e for e in errs)


def test_world_must_divide_envs_and_ring():
    """``num_envs`` and the ring must split evenly over the ranks (JAX's
    message for the envs, ``train.py:328-331``)."""
    mesh = tmesh.Mesh(0, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match=r"num_envs \(8\) must divide the "
                       r"device count \(3\)"):
        Learner(TConfig(**TINY), device="cpu", mesh=mesh)
    mesh = tmesh.Mesh(0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="replay_buffer_size"):
        Learner(TConfig(**dict(TINY, replay_buffer_size=63)), device="cpu",
                mesh=mesh)


def test_mesh_without_a_group_is_one_device():
    """``make_mesh`` without a process group: a world of one, no group;
    the collectives are no-ops; ``initialize_distributed`` at world 1 opens
    nothing, as JAX's at ``num_processes <= 1``."""
    mesh = tmesh.make_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    x = torch.arange(4.0)
    assert tmesh.pmean(x, mesh) is x and torch.equal(x, torch.arange(4.0))
    assert tmesh.gather_rows(x, mesh) is x
    assert tmesh.shard_batch(x, mesh) is x
    assert not tmesh.initialize_distributed(world_size=1, device="cpu")
    assert mesh.rows(8) == slice(0, 8)
