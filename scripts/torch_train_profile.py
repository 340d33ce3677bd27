"""Where the time of the PyTorch port's training superstep goes, on one GPU.

    python3 scripts/torch_train_profile.py [--algo td3|sac|ppo] [--envs 4096]
                                           [--framework MODUL|MONO]
                                           [--module_training DTDE|CTDE]
                                           [--use_equiv 1|0]
                                           [--steps N] [--config A|B]
                                           [--out FILE]

Runs ``train`` (the flagship configuration with TD3, or with
``--framework MONO``, ``--module_training CTDE`` and/or ``--use_equiv 0``
the other configurations, for every algorithm; SAC with
``--algo sac``; one warm superstep, then train supersteps of one 4096-env
tick and one update each; or PPO with ``--algo ppo`` in configuration A,
32 envs and a 7000-step horizon in minibatches of 128, or B, 4096 envs x 50
ticks in minibatches of 3723, as ``utils.config.PPO_CONFIGS`` and
chip_smoke.py define them: 2 epochs per update for A and 1 for B, where
the reference runs 20, since the cost per minibatch step does not depend
on it) and, through its per-superstep probe,
measures three windows of ``--steps`` supersteps (default 60, PPO 1) after
a warm-up of 20 (PPO 1):
  1. timed with CUDA events (ms per superstep, env-steps/s, updates/s);
     right after it, the superstep's update alone (``replay.sample`` and
     the learner's ``train_step`` on fresh draws), ``--steps`` times
     back to back and ``--steps`` times with a sync after each (as
     ``train`` syncs after each superstep), on CUDA events and the host
     clock (off-policy only);
  2. under ``torch.profiler`` (CPU + CUDA): device time by kernel name,
     K3's and K4's (the EMLP block's forward and backward kernels) and
     their shares, and the device-busy share of the wall time;
  3. under ``cProfile``: the host functions that take the superstep's time.
Prints JSON lines; ``--out`` also writes the full profiler tables.
"""
import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WARMUP = 20


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", choices=("td3", "sac", "ppo"), default="td3")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--framework", choices=("MODUL", "MONO"), default="MODUL")
    ap.add_argument("--module_training", choices=("DTDE", "CTDE"),
                    default="DTDE", help="MODUL's training scheme")
    ap.add_argument("--use_equiv", type=int, choices=(0, 1), default=1,
                    help="EMLP (1) or MLP (0) networks")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--config", choices=("A", "B"), default="A",
                    help="PPO configuration")
    ap.add_argument("--out", default=None,
                    help="file for the full profiler tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from gym_rotor_tpu_torch.algos import replay as R
    from gym_rotor_tpu_torch.algos import sac, td3
    from gym_rotor_tpu_torch.envs import draws as D
    from gym_rotor_tpu_torch.kernels import (build, emlp_actor, emlp_block,
                                             env_tick, flat_adamw, gae,
                                             mlp_ppo_actor, mlp_sac_actor,
                                             ppo_loss, replay, sac_sample,
                                             spectral)
    from gym_rotor_tpu_torch.train import train
    from gym_rotor_tpu_torch.utils.config import PPO_CONFIGS, Config

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    build.build_all([m.KERNEL for m in (env_tick, emlp_actor, replay,
                                        emlp_block, flat_adamw, spectral,
                                        sac_sample, gae, ppo_loss,
                                        mlp_ppo_actor, mlp_sac_actor)])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ppo = args.algo == "ppo"
    family = dict(framework=args.framework,
                  module_training=args.module_training,
                  use_equiv=bool(args.use_equiv))
    if ppo:
        cfg = Config(**PPO_CONFIGS[args.config], **family)
        rl = max(cfg.T_horizon // cfg.num_envs, 1)
        rows = rl * cfg.num_envs
        updates = cfg.n_agents * cfg.K_epochs * (
            max(rows // cfg.actor_batch_size, 1)
            + max(rows // cfg.critic_batch_size, 1))
    else:
        cfg = Config(num_envs=args.envs, start_timesteps=args.envs,
                     rl_algo=args.algo.upper(), **family)
        rows, updates = cfg.num_envs, 1
    n = args.steps or (1 if ppo else 60)
    warmup = 1 if ppo else WARMUP
    t_start, p_start, c_start = 1 + warmup, 1 + warmup + n, 1 + warmup + 2 * n
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    cpr = cProfile.Profile()
    marks = {}
    learner, draws_fn = ((sac, D.make_sac_update_draws) if args.algo == "sac"
                         else (td3, D.make_update_draws))
    stack = (sac.caps_stack(cfg.is_ctde) if args.algo == "sac"
             else td3.CAPS_STACK)

    def update_alone(run, synced):
        """ms per update of ``n`` updates, device (events) and host."""
        agents, states, rs = run["agents"], run["states"], run["replay"]
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        h0 = time.perf_counter()
        e0.record()
        for _ in range(n):
            ud = draws_fn(cfg.batch_size, rs.filled, cfg.obs_dim_n,
                          cfg.action_dim_n, [a.critic_widths for a in agents],
                          [a.actor_widths for a in agents], None, dev,
                          ctde=cfg.is_ctde)
            batch = R.sample(rs, cfg.batch_size, idx=ud.idx,
                             ctde=cfg.is_ctde, stack=stack)
            learner.train_step(cfg, agents, states, batch, ud.agents)
            if synced:
                torch.cuda.synchronize()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n, (time.perf_counter() - h0) * 1e3 / n

    def probe(i, warm, metrics, run):
        # i is the superstep that just ended; a window [a, a + n) starts
        # when superstep a - 1 ends
        if i + 1 in (t_start, t_start + n):
            torch.cuda.synchronize()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[i + 1] = (ev, time.perf_counter())
        if i + 1 == t_start + n and not ppo:
            marks["alone"] = update_alone(run, False)
            marks["alone_synced"] = update_alone(run, True)
        if i + 1 == p_start:
            torch.cuda.synchronize()
            prof.start()
            marks["p0"] = time.perf_counter()
        if i + 1 == p_start + n:
            torch.cuda.synchronize()
            marks["p1"] = time.perf_counter()
            prof.stop()
        if i + 1 == c_start:
            torch.cuda.synchronize()
            cpr.enable()
        if i + 1 == c_start + n:
            torch.cuda.synchronize()
            cpr.disable()

    train(cfg, c_start + n, device=dev, on_superstep=probe, log=None)
    (e0, h0), (e1, h1) = marks[t_start], marks[t_start + n]
    ms = e0.elapsed_time(e1) / n
    out = {"card": card, "algo": cfg.rl_algo, "framework": cfg.framework,
           "module_training": cfg.module_training,
           "use_equiv": cfg.use_equiv, "envs": cfg.num_envs,
           "supersteps": n, "env_steps_per_superstep": rows,
           "updates_per_superstep": updates, "ms_per_superstep": ms,
           "host_ms_per_superstep": (h1 - h0) * 1e3 / n,
           "env_steps_per_s": rows / ms * 1e3,
           "updates_per_s": updates / ms * 1e3}
    if ppo:
        out.update(config=args.config, K_epochs=cfg.K_epochs)
    else:
        out.update(update_alone_ms_device_host=marks["alone"],
                   update_alone_synced_ms_device_host=marks["alone_synced"])
    print(json.dumps(out), flush=True)

    wall = marks["p1"] - marks["p0"]
    dev_us = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t and ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[ev.key] = t
    busy = sum(dev_us.values()) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    # K3 and K4 (kernels/csrc/emlp_block.cu), summed over their instances
    blocks = {name: sum(v for k, v in dev_us.items() if any(
        f in k for f in frags)) / n
        for name, frags in (("K3", ("block_fwd_kernel",)),
                            ("K4", ("block_bwd_kernel",
                                    "block_bwd_finish_kernel")))}
    print(json.dumps({"profiled_wall_s": wall, "device_busy_s": busy,
                      "device_busy_share": busy / wall,
                      "device_ms_per_superstep": busy / n * 1e3,
                      "emlp_block_us_per_superstep": blocks,
                      "emlp_block_share_of_device": {
                          k: v / (busy / n * 1e6) for k, v in blocks.items()},
                      "device_us_per_superstep_by_kernel":
                          {k[:60]: v / n for k, v in top}}), flush=True)

    buf = io.StringIO()
    st = pstats.Stats(cpr, stream=buf).sort_stats("tottime")
    st.print_stats(30)
    rows = []
    for (fn, line, name), (cc, nc, tt, ct, _) in sorted(
            st.stats.items(), key=lambda kv: -kv[1][2])[:15]:
        rows.append([f"{os.path.basename(fn)}:{line}:{name}", nc,
                     round(tt / n * 1e3, 4), round(ct / n * 1e3, 4)])
    print(json.dumps({"host_top_tottime_ms_per_superstep": rows}), flush=True)
    # the superstep against its update: the rest is the rollout
    cum = {f"{os.path.basename(os.path.dirname(fn))}/"
           f"{os.path.basename(fn)}:{name}": round(ct / n * 1e3, 4)
           for (fn, _, name), (_, _, _, ct, _) in st.stats.items()
           if name in ("step", "train_step")
           and "gym_rotor_tpu_torch" in fn}
    print(json.dumps({"host_cumtime_ms_per_superstep": cum}), flush=True)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(card + "\n")
            f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                              row_limit=50))
            f.write("\n" + buf.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
