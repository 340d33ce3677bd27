"""Where the time of the PyTorch port's acting rollout goes, on one GPU.

    python3 scripts/torch_rollout_profile.py [--envs 4096] [--ticks 200]
                                             [--out FILE]

Builds the kernels, resets the flagship MODUL envs, warms up, then runs the
same ``rollout`` three times:
  1. timed with CUDA events (env-steps/s, ms per tick);
  2. under ``torch.profiler`` (CPU + CUDA): device time by kernel name and the
     device-busy share of the wall time;
  3. under ``cProfile``: the host functions that take the tick's time.
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--out", default=None,
                    help="file for the full profiler tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from gym_rotor_tpu_torch.envs.batch import batched_reset, rollout
    from gym_rotor_tpu_torch.evaluate import joint_policy
    from gym_rotor_tpu_torch.kernels import build, emlp_actor, env_tick
    from gym_rotor_tpu_torch.models.emlp.zoo import make_actors
    from gym_rotor_tpu_torch.utils.config import Config

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    build.build_all([env_tick.KERNEL, emlp_actor.KERNEL])
    dev = torch.device("cuda", 0)
    cfg = Config(num_envs=args.envs)
    gen = torch.Generator(device=dev).manual_seed(0)
    actors = make_actors(cfg, device=dev, seed=0)
    policy = joint_policy(actors)
    bs, obs = batched_reset(cfg, gen, device=dev)
    bs, obs, _, _ = rollout(cfg, bs, obs, policy, 20, gen)
    torch.cuda.synchronize()

    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    bs, obs, _, _ = rollout(cfg, bs, obs, policy, args.ticks, gen)
    e.record()
    torch.cuda.synchronize()
    ms = s.elapsed_time(e)
    print(json.dumps({"card": card, "envs": args.envs, "ticks": args.ticks,
                      "ms_per_tick": ms / args.ticks,
                      "env_steps_per_s": args.envs * args.ticks / ms * 1e3}),
          flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bs, obs, _, _ = rollout(cfg, bs, obs, policy, args.ticks, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t and ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[ev.key] = t
    busy = sum(dev_us.values()) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({"profiled_wall_s": wall, "device_busy_s": busy,
                      "device_busy_share": busy / wall,
                      "device_us_by_kernel": {k[:60]: v for k, v in top}}),
          flush=True)

    pr = cProfile.Profile()
    pr.enable()
    bs, obs, _, _ = rollout(cfg, bs, obs, policy, args.ticks, gen)
    torch.cuda.synchronize()
    pr.disable()
    buf = io.StringIO()
    st = pstats.Stats(pr, stream=buf).sort_stats("tottime")
    st.print_stats(25)
    rows = []
    for (fn, line, name), (cc, nc, tt, ct, _) in sorted(
            st.stats.items(), key=lambda kv: -kv[1][2])[:12]:
        rows.append([f"{os.path.basename(fn)}:{line}:{name}", nc,
                     round(tt / args.ticks * 1e3, 4),
                     round(ct / args.ticks * 1e3, 4)])
    print(json.dumps({"host_top_tottime_ms_per_tick": rows}), flush=True)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(card + "\n")
            f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                              row_limit=40))
            f.write("\n" + buf.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
