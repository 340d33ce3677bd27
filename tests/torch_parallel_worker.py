"""One rank of a CPU process group for ``tests/test_torch_parallel.py``.

    python tests/torch_parallel_worker.py JOB RANK WORLD STORE OUT

opens a ``gloo`` group of ``WORLD`` ranks through a ``FileStore`` at
``STORE`` (no TCP port, so test files can run side by side), runs the job
``JOB`` names (a ``torch.save``d ``{"fn": name, "kw": {...}}``) on the
CPU and ``torch.save``s its result to ``OUT``.  Imports torch and the port
only; the test process runs the JAX side and compares.
"""
import copy
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from gym_rotor_tpu_torch import convert
from gym_rotor_tpu_torch.algos import ppo as tppo
from gym_rotor_tpu_torch.algos import sac as tsac
from gym_rotor_tpu_torch.algos import td3 as ttd3
from gym_rotor_tpu_torch.kernels import gae as K12
from gym_rotor_tpu_torch.kernels.env_tick import TickLoop
from gym_rotor_tpu_torch.parallel import mesh as M
from gym_rotor_tpu_torch.parallel.train_step import (make_ppo_superstep,
                                                     make_td3_superstep)
from gym_rotor_tpu_torch.train import Learner, main
from gym_rotor_tpu_torch.utils.config import Config
from gym_rotor_tpu_torch.utils.tree import tree_named_leaves

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def snapshot(learner):
    """Everything a rank carries, copied: states, generators, ring or
    horizon, env state, observations, ``ep_ret``, counters."""
    out = dict(states=copy.deepcopy(learner.states),
               gen=learner.gen.get_state(),
               init_gen=learner.init_gen.get_state(),
               env={k: v.clone() for k, v in
                    tree_named_leaves(learner.loop.state)},
               obs=tuple(o.clone() for o in learner.obs),
               ep_ret=learner.ep_ret.clone(),
               total_timesteps=learner.total_timesteps,
               noise=learner.explor_noise_std)
    if learner.off_policy:
        r = learner.replay
        out["ring"] = (r.data.clone(), r.ptr, r.filled)
    return out


def gae(mesh, inputs, gamma, lam):
    """K12's sharded route (its plain twin on CPU tensors) on this rank's
    env columns ``inputs[rank]``."""
    x = [_t(a) for a in inputs[mesh.rank]]
    return K12.gae_sharded(*x, gamma, lam, mesh)


def superstep(mesh, algo, cfg_kw, per_rank, noise_std=0.3, rollout_len=1,
              n_updates=1):
    """The port's superstep over ``mesh`` from JAX's device shard of the
    states, envs and ring, with that device's draws; a snapshot after
    each superstep."""
    cfg = Config(**cfg_kw)
    job = per_rank[mesh.rank]
    agent_cls, conv = {
        "TD3": (ttd3.TD3Agent, convert.td3_state_from_jax),
        "SAC": (tsac.SACAgent, convert.sac_state_from_jax),
        "PPO": (tppo.PPOAgent, convert.ppo_state_from_jax)}[algo]
    agents = [agent_cls(cfg, i, "cpu") for i in range(cfg.n_agents)]
    states = [conv(tree, a) for tree, a in zip(job["states"], agents)]
    loop = TickLoop(cfg, convert.env_state_from_numpy(job["env"],
                                                      device="cpu"))
    obs = tuple(_t(o) for o in job["obs"])
    B = loop.B
    ep_ret = torch.zeros(B, cfg.n_agents)
    if algo == "PPO":
        buf = tppo.HorizonBuffer(cfg, rollout_len, "cpu", num_envs=B)
        step = make_ppo_superstep(cfg, agents, "cpu", rollout_len,
                                  mesh=mesh)
    else:
        buf = convert.replay_state_from_jax(job["ring"], cfg.obs_dim_n,
                                            cfg.action_dim_n, device="cpu")
        hooks = tsac.superstep_hooks(agents) if algo == "SAC" else {}
        step = make_td3_superstep(cfg, agents, "cpu", rollout_len, n_updates,
                                  mesh=mesh, **hooks)
    snaps = []
    for warm, draws in job["steps"]:
        if algo == "PPO":
            obs, m = step(loop, obs, buf, states, ep_ret, draws=draws)
        else:
            obs, m = step(loop, obs, buf, states, ep_ret, noise_std,
                          warm=warm, draws=draws)
        snaps.append(dict(
            obs=tuple(o.clone() for o in obs), ep_ret=ep_ret.clone(),
            metrics={k: v.clone() for k, v in m.items()},
            states=copy.deepcopy(states),
            ring=None if algo == "PPO" else (buf.data.clone(), buf.ptr,
                                             buf.filled)))
    return snaps


def train(mesh, cfg_kw, supersteps):
    """``Learner.superstep`` over ``mesh``; a snapshot (and the metrics)
    after each."""
    learner = Learner(Config(**cfg_kw), device="cpu", mesh=mesh)
    out = []
    for _ in range(supersteps):
        warm, metrics, _ = learner.superstep()
        snap = snapshot(learner)
        snap["metrics"] = {k: v.clone() for k, v in metrics.items()}
        out.append(snap)
    return out


def resume(mesh, cfg_kw, supersteps, path):
    """Train, checkpoint, load into a fresh learner; snapshots of both at
    the load and after one more superstep each."""
    cfg = Config(**cfg_kw)
    a = Learner(cfg, device="cpu", mesh=mesh)
    for _ in range(supersteps):
        a.superstep()
    a.save_checkpoint(path)
    b = Learner(cfg, device="cpu", mesh=mesh)
    b.load_checkpoint(path)
    at_load = (snapshot(a), snapshot(b))
    a.superstep()
    b.superstep()
    return at_load, (snapshot(a), snapshot(b))


def load(mesh, cfg_kw, path):
    """The error a fresh learner's ``load_checkpoint(path)`` raises."""
    try:
        Learner(Config(**cfg_kw), device="cpu", mesh=mesh).load_checkpoint(
            path)
    except ValueError as e:
        return str(e)
    return None


def run_main(mesh, argv, cwd):
    """``train.main(argv, device="cpu")`` in ``cwd`` over the open group;
    the rank's snapshot at the end."""
    os.chdir(cwd)
    return snapshot(main(argv, device="cpu"))


def _main(job, rank, world, store_path, out):
    store = dist.FileStore(store_path, int(world))
    if int(world) > 1:
        M.initialize_distributed(rank=int(rank), world_size=int(world),
                                 device="cpu", store=store)
    else:
        dist.init_process_group("gloo", rank=0, world_size=1, store=store)
    try:
        spec = torch.load(job, weights_only=False)
        result = globals()[spec["fn"]](M.make_mesh("cpu"), **spec["kw"])
        torch.save(result, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(*sys.argv[1:])
