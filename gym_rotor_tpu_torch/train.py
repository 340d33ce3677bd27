"""The training driver on one device (port of ``train.py``: ``Learner``,
``main``) and ``train``, the bare superstep loop.

    python -m gym_rotor_tpu_torch.train [--flag value ...]   # on the card

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
MODUL (DTDE, or CTDE) or MONO, EMLP or MLP networks.  One device, no mesh.
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
from .envs.batch import batched_reset
from .envs.quad import DT
from .evaluate import evaluate
from .kernels.env_tick import TickLoop
from .parallel.train_step import make_ppo_superstep, make_td3_superstep
from .utils import checkpoint as ckpt
from .utils import logging as logs
from .utils.config import Config, config_from_args
from .utils.device import resolve_device


class Learner:
    """The agents, their states, the envs (a ``TickLoop``) and the ring or
    the horizon on one device, seeded from ``cfg.seed``; ``superstep``
    advances them, ``train_policy`` is the JAX driver's loop around it."""

    def __init__(self, cfg: Config, model_dir="./models",
                 results_dir="./results", device=None):
        if cfg.rl_algo not in ("TD3", "SAC", "PPO"):
            raise NotImplementedError(f"only TD3, SAC and PPO are ported, "
                                      f"not {cfg.rl_algo}")
        if cfg.eval_stream not in ("parallel", "reference"):
            raise ValueError(f"unknown eval_stream {cfg.eval_stream!r}: "
                             "expected 'parallel' or 'reference'")
        self.cfg = cfg
        self.model_dir = model_dir
        self.results_dir = results_dir
        dev = self.device = resolve_device(device)
        self.gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        self.init_gen = torch.Generator().manual_seed(cfg.seed)
        sac, ppo = cfg.rl_algo == "SAC", cfg.rl_algo == "PPO"
        self.off_policy = not ppo
        agent_cls = (ppo_lib.PPOAgent if ppo else sac_lib.SACAgent if sac
                     else TD3Agent)
        self.agents = [agent_cls(cfg, i, dev) for i in range(cfg.n_agents)]
        self.states = [a.init(self.init_gen) for a in self.agents]
        bs, self.obs = batched_reset(cfg, self.gen, device=dev)
        self.loop = TickLoop(cfg, bs)
        self.ep_ret = torch.zeros(cfg.num_envs, cfg.n_agents,
                                  dtype=torch.float32, device=dev)
        if ppo:
            self.rollout_len = max(cfg.T_horizon // cfg.num_envs, 1)
            self.n_updates = cfg.K_epochs
            self.horizon = ppo_lib.HorizonBuffer(cfg, self.rollout_len, dev)
            self._step = make_ppo_superstep(cfg, self.agents, dev,
                                            rollout_len=self.rollout_len)
        else:
            self.rollout_len = max(cfg.rollout_len, 1)
            self.n_updates = max(int(round(cfg.updates_per_step
                                           * self.rollout_len)), 1)
            self.replay = replay_lib.create(
                cfg.replay_buffer_size, cfg.obs_dim_n, cfg.action_dim_n,
                device=dev)
            self._step = make_td3_superstep(
                cfg, self.agents, dev, rollout_len=self.rollout_len,
                n_updates=self.n_updates,
                **(sac_lib.superstep_hooks(self.agents) if sac else {}))
        self.steps_per_call = cfg.num_envs * self.rollout_len
        self.total_timesteps = 0
        self.explor_noise_std = cfg.explor_noise_std_init
        self.noise_std_decay = (
            (cfg.explor_noise_std_init - cfg.explor_noise_std_min)
            / cfg.max_timesteps) if cfg.use_explor_noise_decay else 0.0
        self.episodes = []
        self.tb = logs.TensorBoard(
            cfg.save_tensorboard, results_dir,
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
        cfg = self.cfg
        ring = (self.replay if self.off_policy and cfg.checkpoint_replay
                else None)
        return ckpt.train_state_tree(
            cfg, self.states, {"env": self.gen, "init": self.init_gen},
            self.total_timesteps, self.explor_noise_std, ring)

    def save_checkpoint(self, path=None) -> str:
        path = path or self.cfg.checkpoint_path
        return ckpt.save_train_state(path, self.checkpoint_tree())

    def load_checkpoint(self, path=None):
        """Restore a ``save_checkpoint`` file: the states (rebound, so every
        network's ``param_version`` moves), both generators, the counters
        and, if saved, the ring (into this learner's ring, in place)."""
        path = path or self.cfg.checkpoint_path
        out = ckpt.load_train_state(path, self.cfg, self.agents, self.states,
                                    self.device)
        self.states[:] = out["states"]
        self.gen.set_state(out["generators"]["env"])
        self.init_gen.set_state(out["generators"]["init"])
        self.total_timesteps = out["total_timesteps"]
        self.explor_noise_std = out["explor_noise_std"]
        if "replay" in out:
            if not self.off_policy:
                raise ValueError(f"{path} holds a replay ring; "
                                 f"{self.cfg.rl_algo} has none")
            saved = out["replay"]
            data = saved["data"]
            if tuple(data.shape) != tuple(self.replay.data.shape):
                raise ValueError(f"{path}: ring of {list(data.shape)}, this "
                                 f"learner's is "
                                 f"{list(self.replay.data.shape)}")
            self.replay.data.copy_(torch.from_numpy(np.array(data)))
            self.replay.ptr = int(saved["ptr"])
            self.replay.filled = int(saved["filled"])
        return self

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
        saving, train-state checkpoints and the rate print."""
        cfg = self.cfg
        print(f"training on {self.device}: {cfg.num_envs} envs, "
              f"rollout_len={self.rollout_len}, {self.n_updates} "
              f"update{'s' if self.n_updates > 1 else ''}/superstep")
        tl = logs.TextLogs(self.results_dir, cfg.seed)
        thr = logs.Throughput()
        max_total_reward = [0.85 * cfg.eval_max_steps / DT] * cfg.n_agents
        next_eval = cfg.eval_freq
        if cfg.eval_freq < self.steps_per_call:
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
                if mean_ret is not None:
                    tl.log_step(self.total_timesteps, mean_ret)
                if tb_on and not warm:
                    for k, v in metrics.items():
                        if k not in ("fin_sum", "fin_cnt"):
                            self.tb.scalar(f"train/{k}", float(v),
                                           self.total_timesteps)

                if self.total_timesteps >= next_eval and not warm:
                    rewards, bench, success = self.eval_policy()
                    tl.log_eval(self.total_timesteps, bench, list(rewards))
                    self.tb.scalar("reward/benchmark_reward", bench,
                                   self.total_timesteps)
                    for i, r in enumerate(rewards):
                        self.tb.scalar(f"reward/eval_reward{i}", r,
                                       self.total_timesteps)
                        if r > max_total_reward[i] and cfg.save_model:
                            max_total_reward[i] = r
                            self.save_actor(i)
                        if success[:, i].all() and cfg.save_model:
                            self.save_actor(i, solved=True)
                    while next_eval <= self.total_timesteps:
                        next_eval += cfg.eval_freq

                if next_ckpt is not None and self.total_timesteps >= next_ckpt:
                    self.save_checkpoint()
                    next_ckpt += cfg.checkpoint_freq

                if time.perf_counter() - last_report > 10.0:
                    es, us = thr.rates()
                    print(f"t={self.total_timesteps}  env-steps/s={es:,.0f}  "
                          f"updates/s={us:,.1f}  "
                          f"noise={self.explor_noise_std:.3f}")
                    last_report = time.perf_counter()
        finally:
            tl.close()


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
    says otherwise."""
    cfg = config_from_args(argv)
    print("-" * 100)
    print(f"Framework: {cfg.framework} | Equivariant RL: {cfg.use_equiv} | "
          f"RL algorithm: {cfg.rl_algo} | Seed: {cfg.seed}")
    print(f"gamma: {cfg.discount} | lr_a: {list(cfg.lr_a)} | "
          f"lr_c: {list(cfg.lr_c)} | num_envs: {cfg.num_envs} | "
          f"integrator: {cfg.integrator}")
    print("-" * 100)
    learner = Learner(cfg, device=device)
    if cfg.test_model:
        learner.load_best_actors()
        learner.eval_policy()
        return learner
    if cfg.resume and os.path.exists(cfg.checkpoint_path):
        learner.load_checkpoint()
        print(f"resumed from {cfg.checkpoint_path} at "
              f"t={learner.total_timesteps}")
    learner.eval_policy()
    with logs.profiler_trace(cfg.profile_dir or None):
        learner.train_policy()
    return learner


if __name__ == "__main__":
    main()
