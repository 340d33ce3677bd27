"""Where a K12 launch spends its time, phase by phase, on one CUDA device.

    python3 scripts/gae_phase_probe.py

Builds ``kernels/csrc/gae.cu`` a second time with ``GAE_MARK(k)`` defined
to record ``clock64()`` in thread 0 of each CTA (a header passed to
``nvcc -include``; the kernel's own build defines nothing there), launches
the chosen plans at PPO A's (218, 32) (one cluster) and PPO B's
(50, 4096) (a grid of 64 CTAs), PPO A's horizon in one CTA, PPO B's in a
grid of 128 CTAs and in one cluster of 16, and
prints per phase the cycles between the marks (median and largest over the
CTAs, the last of 20 launches), and from the global timer each mark's
spread over the CTAs and its median time from the first CTA's start (the
CTAs' skew beside each phase): 0 -> 1 the first chunk's copies landed
(a resident tile: all of it), 1 -> 2 its delta pass and scan, 2 -> 3 its
td pass and the other chunks, 3 -> 4 the mean's sum across the CTAs,
4 -> 5 the variance's terms, 5 -> 6 its sum, 6 -> 7 the normalisation.
Also the probed build's
and the kernel's own device time a call (``chip_smoke.device_ms``), so the
marks' cost shows, and the SM clock.  One JSON line per plan.
"""
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MARKS = 8
MAX_CTAS = 1024
HEADER = r"""
#pragma once
#include <cuda_runtime.h>
__device__ long long gae_probe_marks[2][%d][%d];
__device__ __forceinline__ long long gae_probe_ns() {
  long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define GAE_MARK(k)                                                   \
  do {                                                                \
    if (threadIdx.x == 0 && blockIdx.x < %d) {                        \
      gae_probe_marks[0][blockIdx.x][k] = clock64();                  \
      gae_probe_marks[1][blockIdx.x][k] = gae_probe_ns();             \
    }                                                                 \
  } while (0)
extern "C" int gae_probe_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, gae_probe_marks,
                                   sizeof(gae_probe_marks));
}
""" % (MAX_CTAS, MARKS, MAX_CTAS)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import ctypes

    import chip_smoke as CS
    from gym_rotor_tpu_torch.kernels import build
    from gym_rotor_tpu_torch.kernels import gae as K
    from gym_rotor_tpu_torch.utils.config import Config
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    hdr = build.BUILD_DIR / "gae_probe.h"
    hdr.write_text(HEADER)
    probe = build.KernelSource("gae", K.KERNEL.flags + ["-include", str(hdr)])
    build.build_all([probe, K.KERNEL])
    lib = K._lib(probe)
    lib.gae_probe_read.argtypes = [ctypes.c_void_p]
    lib.gae_probe_read.restype = ctypes.c_int
    cfg = Config(rl_algo="PPO")
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 13)
    per_us = CS._cycles_per_ms() / 1e3
    print(json.dumps(dict(ptxas=probe.resources(), cycles_per_us=per_us)),
          flush=True)
    for T, B, kw in ((218, 32, {}), (50, 4096, {}),
                     (218, 32, dict(mode="solo")),
                     (50, 4096, dict(mode="grid", cols=32)),
                     (50, 4096, dict(mode="cluster"))):
        v, nv, r = (torch.randn(T, B, 1, generator=gen, device=dev)
                    for _ in range(3))
        d = (torch.rand(T, B, 1, generator=gen, device=dev) < 0.05).float()
        plan = K.gae_plan(T, B, **kw)
        adv, td = torch.empty_like(v), torch.empty_like(v)

        def run(kernel):
            K.gae_launch(v, nv, r, d, cfg.discount, cfg.GAE_lambda, adv, td,
                         plan, kernel)
        for _ in range(20):
            run(probe)
        torch.cuda.synchronize()
        both = np.zeros((2, MAX_CTAS, MARKS), np.int64)
        build.check(lib.gae_probe_read(both.ctypes.data), lib,
                    "gae_probe_read")
        marks, ns = both[0, :plan.ctas], both[1, :plan.ctas]
        steps = np.diff(marks, axis=1)
        rec = dict(T=T, B=B, plan=list(plan),
                   phase_cycles_median=np.median(steps, 0).tolist(),
                   phase_cycles_max=steps.max(0).tolist(),
                   total_us_median=float(np.median(marks[:, -1] - marks[:, 0])
                                         / per_us),
                   # global time: each mark's spread over the CTAs and its
                   # median from the first CTA's start, in ns
                   mark_spread_ns=(ns.max(0) - ns.min(0)).tolist(),
                   mark_median_ns=(np.median(ns, 0) - ns[:, 0].min()).tolist(),
                   probed_ms=CS.device_ms(lambda: run(probe), 200)[0],
                   ms=CS.device_ms(lambda: run(K.KERNEL), 200)[0])
        print(json.dumps(rec), flush=True)
    print(CS.gpu_name_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
