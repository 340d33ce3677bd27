"""Per-phase ``clock64`` breakdown of the run-time acting kernel
(``emlp_actor_any_kernel``) on one CUDA device.

    python3 scripts/rt_actor_phase_probe.py [--out FILE]

Builds a copy of ``csrc/emlp_actor.cu`` with a mark after each step of the
kernel's first tile (lane 0 of every warp writes ``clock64()`` to a
device array): the image and plan copies (the first group), then per
network block its linear layer, its bilinear form and its gate (with the
second group's copies the first time), then the head.  Runs the (64, 16)
actors (both agents) and the (128, 32) actors with each head at 1 row,
a tile shared by a cluster of ``RT_CLUSTER`` blocks (block 0 its rank 0)
and by one block, and at 4096 rows, and prints one JSON line per case: the device ms of the
source as it is and of the marked copy (``chip_smoke.device_ms``), and per
phase the median and the largest cycles over the warps of the tile's
block (block 0); then the card's name and power limit.  A mark follows a
barrier, so a phase's cycles are the slowest warp's.
"""
import argparse
import ctypes
import json
import os
import statistics
import sys
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
NPH = 12
MAX_WARPS = 132 * 32
PHASES = ("stage", "lin0", "bil0", "gate0", "lin1", "bil1", "gate1", "head")
MARK = ("if ((threadIdx.x & 31) == 0 && tile == blockIdx.x / C) "
        "rt_trace[((size_t)blockIdx.x * 32 + (threadIdx.x >> 5)) * %d + (%s)] "
        "= clock64();")
# (anchor in the kernel, mark index after it)
ANCHORS = (
    ("  for (int tile = blockIdx.x / C; tile < n_tiles; "
     "tile += gridDim.x / C) {\n", "0"),
    ("    __pipeline_wait_prior(1);\n    __syncthreads();\n", "1"),
    ("                 f + m[kB], ls, warp, lane, nw);\n"
     "      __syncthreads();\n", "2 + 3 * blk"),
    ("          warp * C + rank, lane, mul);\n"
     "      // every slot of the cluster written and visible\n"
     "      if (C > 1) {\n        cluster::arrive();\n"
     "        cluster::wait();\n      } else {\n"
     "        __syncthreads();\n      }\n", "3 + 3 * blk"),
    ("      __pipeline_wait_prior(0);\n      __syncthreads();\n",
     "4 + 3 * blk"),
    ("                          noise, ld_noise, out, ld_out, logp, "
     "ld_logp,\n                          max_action);\n", "8"),
)


def marked_source(KA):
    """``emlp_actor.cu`` with the marks, written beside the build and
    wrapped as a ``KernelSource`` of the same flags."""
    src = Path(KA.KERNEL.source).read_text()
    src = src.replace("namespace {\n", "__device__ long long rt_trace[%d];\n"
                      "extern \"C\" int rt_trace_read(long long* out) { "
                      "return (int)cudaMemcpyFromSymbol(out, rt_trace, "
                      "sizeof rt_trace); }\n"
                      "namespace {\n" % (MAX_WARPS * NPH), 1)
    for anchor, k in ANCHORS:
        if src.count(anchor) != 1:
            raise ValueError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + MARK % (NPH, k) + "\n")
    path = Path(KA.__file__).parent / "build" / "emlp_actor_marked.cu"
    path.parent.mkdir(exist_ok=True)
    path.write_text(src)
    base = type(KA.KERNEL)

    class Marked(base):
        @property
        def source(self):
            return path
    return Marked("emlp_actor_marked",
                  KA.KERNEL.flags + ["-I", str(Path(KA.KERNEL.source).parent)])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import chip_smoke as cs
    from gym_rotor_tpu_torch.kernels import build
    from gym_rotor_tpu_torch.kernels import emlp_actor as KA
    from gym_rotor_tpu_torch.models.emlp import zoo
    from gym_rotor_tpu_torch.utils import config
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from rt_actor_spectral_vs_parent import HEADS, make_actor
    dev = torch.device("cuda", 0)
    cs.CARD = cs.gpu_name_power()
    marked = marked_source(KA)
    plain_src = KA.KERNEL
    build.build_all([plain_src, marked])
    lib = marked.load()
    lib.rt_trace_read.argtypes = [ctypes.c_void_p]
    trace = (ctypes.c_longlong * (MAX_WARPS * NPH))()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    lines = []
    for ah in ((64, 16), (128, 32)):
        for agent in (0, 1):
            for head, name in HEADS.items():
                actor = make_actor(zoo, config, ah, agent, head, dev, cs.SEED)
                f = KA.fold_actor(actor)
                for nb, csize in ((1, KA.RT_CLUSTER), (1, 1), (4096, 1)):
                    o = torch.randn(nb, f["dims"][0], generator=gen,
                                    device=dev)
                    noise = torch.randn(nb, f["dims"][3], generator=gen,
                                        device=dev)
                    extra = () if head == "tanh" else (noise,)
                    call = lambda: getattr(KA, name)(actor, o, *extra)
                    KA._FORCE["cluster"] = csize
                    try:
                        with torch.no_grad():
                            ms = cs.device_ms(call, 50)[0]
                            KA.KERNEL = marked
                            ms_marked = cs.device_ms(call, 50)[0]
                            call()
                            torch.cuda.synchronize()
                    finally:
                        KA.KERNEL = plain_src
                        KA._FORCE.pop("cluster")
                    if lib.rt_trace_read(ctypes.addressof(trace)) != 0:
                        raise RuntimeError("rt_trace_read failed")
                    warps = f["warps"]
                    per = {}
                    for k, ph in enumerate(PHASES):
                        d = [trace[w * NPH + k + 1] - trace[w * NPH + k]
                             for w in range(warps)]
                        per[ph] = [statistics.median(d), max(d)]
                    rec = dict(kernel=name, width=list(ah), agent=agent,
                               dims=list(f["dims"]), batch=nb, cluster=csize,
                               warps=warps,
                               slots=f["slots"], ms=ms, ms_marked=ms_marked,
                               cycles_median_max=per,
                               total_cycles=trace[8] - trace[0],
                               card=cs.CARD)
                    lines.append(rec)
                    print(json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in lines))
    print(cs.CARD, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
