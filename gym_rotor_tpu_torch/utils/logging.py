"""Metrics and logging channels (port of ``gym_rotor_tpu/utils/logging.py``).

The reference's four channels: stdout prints, the text logs
``log_step_seed_{seed}.txt`` / ``log_eval_seed_{seed}.txt``, optional
TensorBoard scalars and the flight ``.dat`` logs that the offline analysis
reads (``analysis/draw_plot.py``); besides, the env-steps/s and updates/s
counters and a ``torch.profiler`` trace hook.  ``TextLogs``, ``FlightLog``
and ``Throughput`` are the JAX module's, line for line.
"""
from __future__ import annotations

import contextlib
import os
import time
from datetime import datetime
from typing import Optional

import numpy as np


class TextLogs:
    """log_step / log_eval text files (reference main.py:120-123)."""

    def __init__(self, results_dir: str, seed: int):
        os.makedirs(results_dir, exist_ok=True)
        self.step_f = open(
            os.path.join(results_dir, f"log_step_seed_{seed}.txt"), "w+")
        self.eval_f = open(
            os.path.join(results_dir, f"log_eval_seed_{seed}.txt"), "w+")

    def log_step(self, total_timesteps, episode_reward):
        self.step_f.write(f"{total_timesteps}\t {episode_reward}\n")
        self.step_f.flush()

    def log_eval(self, total_timesteps, benchmark_reward, eval_reward):
        self.eval_f.write(
            f"{total_timesteps}\t {benchmark_reward}\t {eval_reward}\n")
        self.eval_f.flush()

    def close(self):
        self.step_f.close()
        self.eval_f.close()


class TensorBoard:
    """Optional TensorBoard writer (``torch.utils.tensorboard``); a no-op
    when disabled, or when the ``tensorboard`` package is missing, which the
    writer needs: then, when asked for, it says once that it is off."""

    def __init__(self, enabled: bool, results_dir: str, tag: str):
        self.writer = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
            self.writer = SummaryWriter(
                os.path.join(results_dir, "tensorboard", f"{stamp}_{tag}"))
        except ImportError as e:    # the tensorboard package is absent
            print(f"TensorBoard is off: {type(e).__name__}: {e}")

    def scalar(self, name, value, step):
        if self.writer is not None:
            self.writer.add_scalar(name, float(value), int(step))


class FlightLog:
    """Flight .dat log writer: rows = [action | state(18) + eIx + eb1 + eIb1
    | xd, vd, b1c, Wd], %.10f format (reference main.py:343-352, 381-389)."""

    def __init__(self):
        self.act_list, self.obs_list, self.cmd_list = [], [], []

    def append(self, action, state18, eIx, eb1, eIb1, xd, vd, b1c, Wd):
        self.obs_list.append(
            np.concatenate((state18, eIx, [eb1], [eIb1]), axis=None))
        self.cmd_list.append(np.concatenate((xd, vd, b1c, Wd), axis=None))
        self.act_list.append(np.asarray(action))

    def save(self, results_dir: str, framework: str) -> Optional[str]:
        if not self.act_list:
            return None
        n = min(len(self.act_list), len(self.obs_list), len(self.cmd_list))
        data = np.column_stack(
            (self.act_list[-n:], self.obs_list[-n:], self.cmd_list[-n:]))
        return save_rows(results_dir, framework, data)


def save_rows(results_dir: str, framework: str, rows) -> str:
    """Flight-log rows to ``{framework}_log_{stamp}.dat`` in the reference's
    format (``train.py:269-277``); returns the path."""
    header = ("Actions and States\n"
              "action[0], ..., state[0], ..., command[0], ...")
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, f"{framework}_log_{stamp}.dat")
    np.savetxt(path, np.asarray(rows), header=header, fmt="%.10f")
    return path


class Throughput:
    """env-steps/s and updates/s counters (the benchmark metric)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.env_steps = 0
        self.updates = 0

    def add(self, env_steps=0, updates=0):
        self.env_steps += env_steps
        self.updates += updates

    def rates(self):
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return self.env_steps / dt, self.updates / dt


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Record the block under ``torch.profiler`` (CPU, and CUDA where a
    card is present) and write a Chrome trace into ``log_dir``
    (``trace_{stamp}.json``); nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    path = os.path.join(log_dir, f"trace_{stamp}.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace saved: {path}")
