"""The training driver on one device or over a process group (port of
``train.py``: ``Learner``, ``main``) and ``train``, the bare superstep loop.

    python -m gym_rotor_tpu_torch.train [--flag value ...]   # on the card
    python -m torch.distributed.run --nproc_per_node 8 \
        -m gym_rotor_tpu_torch.train [--flag value ...]     # on 8 cards

takes the JAX driver's flags and defaults (``utils/config.py``:
``create_parser``); the defaults are the flagship, TD3 on MODUL with EMLP
actors and critics, RK4, 4096 envs.  ``main(argv, device=None)`` does what
the JAX ``main`` does: an eval before training, then ``train_policy``:
supersteps until ``max_timesteps``, behind the ``start_timesteps`` warm-up
gate (off-policy); an eval every ``eval_freq`` env-steps once warm (every
superstep when ``eval_freq`` is under a superstep's env-steps), saving an
agent's actor when its eval reward beats its best so far (starting at
``0.85 * eval_max_steps / DT``) and, as ``_solved``, when every eval
episode succeeds; the per-episode step log and the eval log
(``utils/logging.py``), TensorBoard scalars when asked, the linear noise
decay (TD3), the rate print every 10 s, a train-state checkpoint every
``checkpoint_freq`` env-steps (``utils/checkpoint.py``).  ``--resume``
starts from ``checkpoint_path`` where it exists; ``--test_model`` loads each
agent's newest saved actor and evaluates it; ``--save_log`` writes the eval's
``.dat`` flight log and ``--render`` draws it; ``--profile_dir`` records a
``torch.profiler`` trace of the training.  Everything runs on the card unless
``device="cpu"`` is passed, as the tests do: ``main(argv, device="cpu")``.

``train(cfg, supersteps)`` runs a fixed number of supersteps through the same
``Learner.superstep`` and nothing else (no eval, no saving):

    from gym_rotor_tpu_torch.train import train
    out = train(Config(), supersteps=1000)             # TD3 on the card
    out = train(Config(framework="MONO", use_equiv=False), 1000)
    out = train(Config(rl_algo="SAC"), supersteps=1000)
    out = train(Config(rl_algo="PPO", num_envs=32), supersteps=100)
    out = train(Config(rl_algo="SAC", module_training="CTDE"), 1000)
    out = train(Config(num_envs=8, ...), 5, device="cpu")

Off-policy (TD3, SAC): a replay ring, the warm-up gate and, for TD3, the
exploration-noise decay (``train.py:421``); ``cfg.rl_algo == "SAC"`` runs
the same superstep with the SAC hooks (``algos/sac.py``).  On-policy
(``"PPO"``, ``train.py:369-375``): each superstep is one horizon of
``max(T_horizon // num_envs, 1)`` ticks and one full PPO update, with no
ring and no warm-up.  Every configuration the JAX package accepts runs:
MODUL (DTDE, or CTDE) or MONO, EMLP or MLP networks.

Over a process group (``torchrun``, or a group the caller opened;
``parallel/mesh.py``) the JAX driver's one path for any device count
(``train.py:326-341``): each rank steps ``num_envs / world`` envs into a
ring of ``replay_buffer_size / world`` rows (or its share of the horizon)
and the parameters stay replicated through the averaged gradients
(``parallel/train_step.py``).  Every rank resets the same global env batch
from ``cfg.seed`` and keeps its rows, as ``sharded_init`` does; rank 0
then goes on with that generator (so a world of one is today's stream),
rank ``r`` with one seeded from ``(seed, r)`` (``mesh.rank_seed``, JAX's
``fold_in(key, axis_index)``).  Rank 0 alone prints, evaluates and writes
the logs, TensorBoard, actor files and checkpoints; the others wait at a
barrier.  Every decision on the host reads reduced metrics or counters
that are the same on every rank, so no rank skips a collective.
"""
from __future__ import annotations

import glob
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import convert
from .algos import ppo as ppo_lib
from .algos import replay as replay_lib
from .algos import sac as sac_lib
from .algos.td3 import TD3Agent
from .envs import draws as D
from .envs.batch import batched_reset
from .envs.quad import DT
from .evaluate import evaluate
from .kernels.env_tick import TickLoop
from .parallel import mesh as mesh_lib
from .parallel.train_step import (make_ppo_superstep, make_td3_superstep,
                                  shard_replay)
from .utils import checkpoint as ckpt
from .utils import logging as logs
from .utils.config import Config, config_from_args
from .utils.device import resolve_device
from .utils.tree import tree_from_named, tree_leaves, tree_named_leaves


class Learner:
    """The agents, their states, the envs (a ``TickLoop``) and the ring or
    the horizon on one device (this rank's share over ``mesh``), seeded
    from ``cfg.seed``; ``superstep`` advances them, ``train_policy`` is the
    JAX driver's loop around it.  ``mesh`` defaults to
    ``parallel.mesh.make_mesh(device)``: the open process group, or one
    device."""

    def __init__(self, cfg: Config, model_dir="./models",
                 results_dir="./results", device=None, mesh=None):
        if cfg.rl_algo not in ("TD3", "SAC", "PPO"):
            raise NotImplementedError(f"only TD3, SAC and PPO are ported, "
                                      f"not {cfg.rl_algo}")
        if cfg.eval_stream not in ("parallel", "reference"):
            raise ValueError(f"unknown eval_stream {cfg.eval_stream!r}: "
                             "expected 'parallel' or 'reference'")
        self.cfg = cfg
        self.model_dir = model_dir
        self.results_dir = results_dir
        sac, ppo = cfg.rl_algo == "SAC", cfg.rl_algo == "PPO"
        self.off_policy = not ppo
        mesh = self.mesh = mesh if mesh is not None else \
            mesh_lib.make_mesh(device)
        dev = self.device = (mesh.device if device is None
                             else resolve_device(device))
        world = mesh.world
        if cfg.num_envs % world:                       # train.py:328-331
            raise ValueError(
                f"num_envs ({cfg.num_envs}) must divide the device count "
                f"({world})")
        if self.off_policy and cfg.replay_buffer_size % world:
            raise ValueError(
                f"replay_buffer_size ({cfg.replay_buffer_size}) must split "
                f"evenly over the device count ({world})")
        self.lead = mesh.rank == 0
        self.num_envs = cfg.num_envs // world          # this rank's envs
        self.gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        self.init_gen = torch.Generator().manual_seed(cfg.seed)
        agent_cls = (ppo_lib.PPOAgent if ppo else sac_lib.SACAgent if sac
                     else TD3Agent)
        self.agents = [agent_cls(cfg, i, dev) for i in range(cfg.n_agents)]
        self.states = [a.init(self.init_gen) for a in self.agents]
        # the same global reset on every rank, each keeping its rows
        # (train_step.py:317-331), then the rank's own stream
        draws = D.draw_uniforms(cfg.num_envs, self.gen, torch.float32, dev)
        bs, self.obs = batched_reset(
            cfg.replace(num_envs=self.num_envs), device=dev,
            draws=draws[mesh.rows(cfg.num_envs)].contiguous())
        if mesh.rank > 0:
            self.gen = torch.Generator(device=dev).manual_seed(
                mesh_lib.rank_seed(cfg.seed, mesh.rank))
        mesh_lib.replicate([t for st in self.states for t in tree_leaves(st)
                            if isinstance(t, torch.Tensor)], mesh)
        self.loop = TickLoop(cfg, bs)
        self.ep_ret = torch.zeros(self.num_envs, cfg.n_agents,
                                  dtype=torch.float32, device=dev)
        if ppo:
            self.rollout_len = max(cfg.T_horizon // cfg.num_envs, 1)
            self.n_updates = cfg.K_epochs
            self.horizon = ppo_lib.HorizonBuffer(cfg, self.rollout_len, dev,
                                                 num_envs=self.num_envs)
            self._step = make_ppo_superstep(cfg, self.agents, dev,
                                            rollout_len=self.rollout_len,
                                            mesh=mesh)
        else:
            self.rollout_len = max(cfg.rollout_len, 1)
            self.n_updates = max(int(round(cfg.updates_per_step
                                           * self.rollout_len)), 1)
            self.replay = replay_lib.create(
                cfg.replay_buffer_size // world, cfg.obs_dim_n,
                cfg.action_dim_n, device=dev)
            self._step = make_td3_superstep(
                cfg, self.agents, dev, rollout_len=self.rollout_len,
                n_updates=self.n_updates, mesh=mesh,
                **(sac_lib.superstep_hooks(self.agents) if sac else {}))
        self.steps_per_call = cfg.num_envs * self.rollout_len
        self.total_timesteps = 0
        self.explor_noise_std = cfg.explor_noise_std_init
        self.noise_std_decay = (
            (cfg.explor_noise_std_init - cfg.explor_noise_std_min)
            / cfg.max_timesteps) if cfg.use_explor_noise_decay else 0.0
        self.episodes = []
        self.tb = logs.TensorBoard(
            cfg.save_tensorboard and self.lead, results_dir,
            f"{cfg.rl_algo}_{cfg.seed}_{cfg.framework}")

    # ------------------------------------------------------------------
    def superstep(self):
        """One superstep: ``rollout_len`` ticks into the ring (or the
        horizon), then the updates unless warm.  Returns ``(warm, metrics,
        mean finished return per agent or None)``; the return is logged in
        ``episodes`` when episodes finished on a train superstep.  Reads
        ``fin_cnt`` on the host: the superstep's one sync."""
        cfg = self.cfg
        warm = self.off_policy and self.total_timesteps < cfg.start_timesteps
        if self.off_policy:
            self.obs, metrics = self._step(
                self.loop, self.obs, self.replay, self.states, self.ep_ret,
                self.explor_noise_std, warm=warm, generator=self.gen)
        else:
            self.obs, metrics = self._step(
                self.loop, self.obs, self.horizon, self.states, self.ep_ret,
                generator=self.gen)
        self.total_timesteps += self.steps_per_call
        mean_ret = None
        fin_cnt = float(metrics["fin_cnt"])
        if fin_cnt > 0 and not warm:
            mean_ret = [round(float(r), 4)
                        for r in (metrics["fin_sum"] / fin_cnt).tolist()]
            self.episodes.append((self.total_timesteps, mean_ret))
        if cfg.rl_algo == "TD3" and cfg.use_explor_noise_decay:
            self.explor_noise_std = max(
                self.explor_noise_std
                - self.noise_std_decay * self.steps_per_call,
                cfg.explor_noise_std_min)
        return warm, metrics, mean_ret

    def run(self) -> dict:
        """What ``train`` returns: the agents, their states, the tick loop,
        the last obs, ``ep_ret``, ``total_timesteps``, ``noise_std``,
        ``episodes`` and the ring (off-policy) or the horizon (PPO)."""
        buf = ({"replay": self.replay} if self.off_policy
               else {"horizon": self.horizon})
        return dict(agents=self.agents, states=self.states, loop=self.loop,
                    obs=self.obs, ep_ret=self.ep_ret,
                    total_timesteps=self.total_timesteps,
                    noise_std=self.explor_noise_std, episodes=self.episodes,
                    **buf)

    # ------------------------------------------------------------------
    def actors(self):
        """Each agent's acting module, bound to its current state."""
        return [a.bound_actor(st) for a, st in zip(self.agents, self.states)]

    def actor_tree(self, i: int) -> dict:
        """Agent ``i``'s actor as the flax tree of numpy arrays that
        ``save_actor`` writes."""
        return convert.flat_to_jax(self.states[i].actor,
                                   self.agents[i].actor_layout)

    def save_actor(self, i: int, solved: bool = False) -> str:
        cfg = self.cfg
        return ckpt.save_actor(self.model_dir, self.actor_tree(i),
                               cfg.rl_algo, cfg.framework,
                               self.total_timesteps, i, cfg.seed, solved)

    def load_actor(self, i: int, path: str) -> None:
        """Load agent ``i``'s actor from ``path`` into its state in place,
        through the bound module's ``load_state_dict``, which bumps its
        ``param_version`` (the acting kernel's fold cache refolds)."""
        agent, st = self.agents[i], self.states[i]
        tree = ckpt.load_actor(path, self.actor_tree(i))
        flat = convert.flat_from_jax(tree, agent.actor_layout, self.device,
                                     agent.dtype)
        agent.bound_actor(st).load_state_dict(agent.actor_layout.views(flat))

    def load_best_actors(self):
        """Load saved actor weights for evaluation (``--test_model``): per
        agent the newest file matching ``{algo}_{framework}_*agent_{i}*_
        {seed}.msgpack`` in ``model_dir``, by modification time, as the
        JAX driver picks it (``train.py:212-230``): a stable sort on mtime,
        so files with equal mtimes keep ``glob``'s order (the directory's)
        and the last of them is taken."""
        cfg = self.cfg
        for i in range(cfg.n_agents):
            pat = os.path.join(
                self.model_dir,
                f"{cfg.rl_algo}_{cfg.framework}_*agent_{i}*_{cfg.seed}"
                ".msgpack")
            cands = sorted(glob.glob(pat), key=os.path.getmtime)
            if not cands:
                raise FileNotFoundError(f"no actor checkpoint matches {pat}")
            self.load_actor(i, cands[-1])
            print(f"agent {i}: loaded {cands[-1]}")
        return self

    # ------------------------------------------------------------------
    def checkpoint_tree(self) -> dict:
        """The train-state map (``utils/checkpoint.py``).  Over a process
        group a collective: the ring is the ranks' rings gathered in rank
        order (JAX's global layout), and ``mesh`` holds the world size,
        every rank's generators and SAC temperature, and the env state,
        observations and ``ep_ret`` gathered likewise."""
        cfg, mesh = self.cfg, self.mesh
        ring = (self.replay if self.off_policy and cfg.checkpoint_replay
                else None)
        if ring is not None:
            ring = replay_lib.ReplayState(
                mesh_lib.gather_rows(ring.data, mesh), ring.ptr, ring.filled,
                ring.dims)
        gens = {"env": self.gen, "init": self.init_gen}
        tree = ckpt.train_state_tree(
            cfg, self.states, gens, self.total_timesteps,
            self.explor_noise_std, ring)
        if mesh.sharded:
            def rows(x):
                return mesh_lib.gather_rows(x, mesh).cpu().numpy()
            tree["mesh"] = ckpt.mesh_tree(
                mesh_lib.gather_objects(ckpt.rank_tree(self.states, gens),
                                        mesh),
                {k: rows(v) for k, v in tree_named_leaves(self.loop.state)},
                [rows(o) for o in self.obs], rows(self.ep_ret))
        return tree

    def save_checkpoint(self, path=None) -> str:
        """Write the train state to ``path`` (default
        ``cfg.checkpoint_path``); over a process group every rank takes
        part in the gathers and rank 0 writes the file."""
        path = path or self.cfg.checkpoint_path
        tree = self.checkpoint_tree()
        if self.lead:
            ckpt.save_train_state(path, tree)
        mesh_lib.barrier(self.mesh)
        return path

    def load_checkpoint(self, path=None):
        """Restore a ``save_checkpoint`` file: the states (rebound, so every
        network's ``param_version`` moves), both generators, the counters
        and, if saved, the ring (into this learner's ring, in place).  Over
        a process group of the size that saved it each rank takes its own
        generators, SAC temperature, ring rows, env state, observations and
        ``ep_ret``; a file of another world size raises ``ValueError``
        (JAX reshards it silently: a stated divergence)."""
        path = path or self.cfg.checkpoint_path
        mesh = self.mesh
        out = ckpt.load_train_state(path, self.cfg, self.agents, self.states,
                                    self.device)
        saved_world = ckpt.saved_world(out)
        if saved_world != mesh.world:
            raise ValueError(
                f"{path} was saved by a world of {saved_world} rank(s); this "
                f"run has {mesh.world}: resume at the same world size")
        self.states[:] = out["states"]
        gens = out["generators"]
        if mesh.sharded:
            gens = ckpt.load_rank_tree(out["mesh"]["ranks"][mesh.rank],
                                       self.states, self.device,
                                       f"{path}/mesh/ranks/{mesh.rank}")
        self.gen.set_state(gens["env"])
        self.init_gen.set_state(gens["init"])
        self.total_timesteps = out["total_timesteps"]
        self.explor_noise_std = out["explor_noise_std"]
        if "replay" in out:
            if not self.off_policy:
                raise ValueError(f"{path} holds a replay ring; "
                                 f"{self.cfg.rl_algo} has none")
            saved = shard_replay(replay_lib.ReplayState(
                torch.from_numpy(np.array(out["replay"]["data"])),
                int(out["replay"]["ptr"]), int(out["replay"]["filled"])),
                mesh)
            data = saved.data
            if tuple(data.shape) != tuple(self.replay.data.shape):
                raise ValueError(f"{path}: ring of {list(data.shape)}, this "
                                 f"learner's is "
                                 f"{list(self.replay.data.shape)}")
            self.replay.data.copy_(data)
            self.replay.ptr, self.replay.filled = saved.ptr, saved.filled
        if mesh.sharded:
            self._load_envs(out["mesh"])
        return self

    def _load_envs(self, saved) -> None:
        """This rank's rows of a checkpoint's gathered env state,
        observations and ``ep_ret``."""
        rows, dev = self.mesh.rows(self.cfg.num_envs), self.device

        def mine(a):
            return torch.from_numpy(np.array(a)[rows]).to(dev)
        leaves = {k: mine(v) for k, v in saved["env"].items()}
        self.loop = TickLoop(self.cfg, tree_from_named(self.loop.state,
                                                       leaves))
        self.obs = tuple(mine(o) for o in saved["obs"])
        self.ep_ret.copy_(mine(saved["ep_ret"]))

    # ------------------------------------------------------------------
    def eval_policy(self):
        """The eval (``evaluate``: ``num_eval`` envs for ``eval_max_steps``
        seconds from a fresh ``EVAL_SEED`` generator); prints the JAX
        driver's line and returns ``(eval reward per agent (float32
        array), benchmark reward, success (num_eval, n_agents) bool)``.
        One sync reads the results (a second the flight-log rows, under
        ``save_log`` or ``render``)."""
        cfg = self.cfg
        rewards, bench, success, _, _, rows = evaluate(
            cfg, self.actors(), device=self.device)
        na = cfg.n_agents
        host = torch.cat([rewards.float(), bench.reshape(1).float(),
                          success.reshape(-1).float()]).cpu().numpy()
        rewards = host[:na]
        bench = float(host[na])
        success = host[na + 1:].reshape(-1, na) > 0.5
        if rows is not None:
            rows = rows.cpu().numpy()
            if cfg.save_log:
                path = logs.save_rows(self.results_dir, cfg.framework, rows)
                print(f"flight log saved: {path}")
            if cfg.render:
                self.render_rows(rows)
        print(
            f"total_timesteps: {self.total_timesteps} \t eval_reward: "
            f"{[round(float(r), 4) for r in rewards]} \t benchmark_reward: "
            f"{bench:.4f}")
        return rewards, bench, success

    def render_rows(self, rows, max_frames=150):
        """Draw env 0's eval flight from its flight-log rows; on a headless
        backend save it as an animated GIF and a final-frame PNG beside the
        logs (``train.py:286-315``)."""
        from datetime import datetime

        from .render.renderer import Renderer

        na = sum(self.cfg.action_dim_n)
        s18 = rows[:, na:na + 18]
        cmd = rows[:, na + 18 + 5:]
        r = Renderer(capture=True)
        try:
            stride = max(1, len(rows) // max_frames)
            for row_s, row_c in zip(s18[::stride], cmd[::stride]):
                x = row_s[0:3]
                R = row_s[6:15].reshape(3, 3).T  # column-major (pack_state)
                xd, b1c = row_c[0:3], row_c[6:9]
                r.draw(x, R, xd, b1c)
            if not r.interactive:
                os.makedirs(self.results_dir, exist_ok=True)
                stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
                path = os.path.join(self.results_dir, f"render_{stamp}.png")
                r.save(path)
                gif = os.path.join(self.results_dir, f"render_{stamp}.gif")
                r.save_animation(gif)
                print(f"render saved: {path}, {gif}")
        finally:
            r.close()

    # ------------------------------------------------------------------
    def train_policy(self):
        """Supersteps until ``max_timesteps``, with the JAX driver's
        protocol around them (``train.py:317-458``): the per-episode step
        log, TensorBoard scalars, periodic eval with best and solved actor
        saving, train-state checkpoints and the rate print.  Over a process
        group rank 0 evaluates, logs and saves while the others wait at a
        barrier; every rank takes part in each checkpoint's gathers."""
        cfg, mesh, lead = self.cfg, self.mesh, self.lead
        if lead:
            print(f"training over {mesh.world} device(s): {cfg.num_envs} "
                  f"envs, rollout_len={self.rollout_len}, {self.n_updates} "
                  f"update{'s' if self.n_updates > 1 else ''}/superstep")
        tl = logs.TextLogs(self.results_dir, cfg.seed) if lead else None
        thr = logs.Throughput()
        max_total_reward = [0.85 * cfg.eval_max_steps / DT] * cfg.n_agents
        next_eval = cfg.eval_freq
        if cfg.eval_freq < self.steps_per_call and lead:
            print(f"note: eval_freq ({cfg.eval_freq}) < steps/superstep "
                  f"({self.steps_per_call}); evaluating once per superstep "
                  f"— raise --eval_freq for throughput")
        next_ckpt = (self.total_timesteps + cfg.checkpoint_freq
                     if cfg.checkpoint_freq else None)
        last_report = time.perf_counter()
        tb_on = self.tb.writer is not None

        try:
            while self.total_timesteps < cfg.max_timesteps:
                warm, metrics, mean_ret = self.superstep()
                thr.add(env_steps=self.steps_per_call,
                        updates=0 if warm else self.n_updates)
                if mean_ret is not None and lead:
                    tl.log_step(self.total_timesteps, mean_ret)
                if tb_on and not warm:
                    for k, v in metrics.items():
                        if k not in ("fin_sum", "fin_cnt"):
                            self.tb.scalar(f"train/{k}", float(v),
                                           self.total_timesteps)

                if self.total_timesteps >= next_eval and not warm:
                    if lead:
                        self._eval_and_save(tl, max_total_reward)
                    mesh_lib.barrier(mesh)
                    while next_eval <= self.total_timesteps:
                        next_eval += cfg.eval_freq

                if next_ckpt is not None and self.total_timesteps >= next_ckpt:
                    self.save_checkpoint()
                    next_ckpt += cfg.checkpoint_freq

                if time.perf_counter() - last_report > 10.0 and lead:
                    es, us = thr.rates()
                    print(f"t={self.total_timesteps}  env-steps/s={es:,.0f}  "
                          f"updates/s={us:,.1f}  "
                          f"noise={self.explor_noise_std:.3f}")
                    last_report = time.perf_counter()
        finally:
            if tl is not None:
                tl.close()

    def _eval_and_save(self, tl, max_total_reward) -> None:
        """One eval, its log lines and scalars, and the best and solved
        actor files (``train.py:434-453``)."""
        cfg = self.cfg
        rewards, bench, success = self.eval_policy()
        tl.log_eval(self.total_timesteps, bench, list(rewards))
        self.tb.scalar("reward/benchmark_reward", bench,
                       self.total_timesteps)
        for i, r in enumerate(rewards):
            self.tb.scalar(f"reward/eval_reward{i}", r, self.total_timesteps)
            if r > max_total_reward[i] and cfg.save_model:
                max_total_reward[i] = r
                self.save_actor(i)
            if success[:, i].all() and cfg.save_model:
                self.save_actor(i, solved=True)


def train(cfg: Config, supersteps: int, device=None,
          on_superstep: Optional[Callable] = None,
          log: Optional[Callable] = print):
    """Run ``supersteps`` supersteps of ``cfg.num_envs * rollout_len``
    env-steps each (``Learner.superstep``), with no eval and no saving.
    Returns the run (``Learner.run``): the agents, their states, the ring
    (off-policy) or the horizon (PPO), the tick loop, the last obs,
    ``ep_ret``, ``total_timesteps``, ``noise_std`` and ``episodes``, the
    per-episode log ``(timestep, mean finished return per agent)``.
    ``on_superstep(i, warm, metrics, run)`` is called after each superstep
    (the caller's probe: timing, launch counts)."""
    learner = Learner(cfg, device=device)
    for i in range(supersteps):
        warm, metrics, mean_ret = learner.superstep()
        if mean_ret is not None and log is not None:
            log(f"t={learner.total_timesteps} episode return {mean_ret}")
        if on_superstep is not None:
            on_superstep(i, warm, metrics, learner.run())
    return learner.run()


def main(argv=None, device=None):
    """The CLI driver: parse ``argv`` (``sys.argv`` when None), then
    evaluate only (``--test_model``), or resume (``--resume``), evaluate and
    train.  Returns the ``Learner``.  Runs on the card unless ``device``
    says otherwise.  Under ``torchrun`` (``WORLD_SIZE`` > 1) it opens the
    process group (``parallel/mesh.py::initialize_distributed``; ``nccl``
    on the cards, ``gloo`` with ``device="cpu"``) and closes it at the
    end; a group the caller opened is used as it is.  Rank 0 prints,
    evaluates and saves."""
    cfg = config_from_args(argv)
    opened = mesh_lib.initialize_distributed(device=device)
    try:
        mesh = mesh_lib.make_mesh(device)
        lead = mesh.rank == 0
        if lead:
            print("-" * 100)
            print(f"Framework: {cfg.framework} | Equivariant RL: "
                  f"{cfg.use_equiv} | RL algorithm: {cfg.rl_algo} | Seed: "
                  f"{cfg.seed}")
            print(f"gamma: {cfg.discount} | lr_a: {list(cfg.lr_a)} | "
                  f"lr_c: {list(cfg.lr_c)} | num_envs: {cfg.num_envs} | "
                  f"integrator: {cfg.integrator}")
            print("-" * 100)
        learner = Learner(cfg, mesh=mesh)
        if cfg.test_model:
            if lead:
                learner.load_best_actors()
                learner.eval_policy()
            mesh_lib.barrier(mesh)
            return learner
        if cfg.resume and os.path.exists(cfg.checkpoint_path):
            learner.load_checkpoint()
            if lead:
                print(f"resumed from {cfg.checkpoint_path} at "
                      f"t={learner.total_timesteps}")
        if lead:
            learner.eval_policy()
        mesh_lib.barrier(mesh)
        with logs.profiler_trace((cfg.profile_dir or None) if lead
                                 else None):
            learner.train_policy()
        return learner
    finally:
        if opened:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
