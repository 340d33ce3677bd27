"""Per-phase ``clock64`` breakdown of K1's tick on one CUDA device, and the
one-thread-per-env design's time under ``-fmad=true``.

    python3 scripts/env_tick_phase_probe.py --design thread --src DIR/gym_rotor_tpu_torch/kernels/csrc/env_tick.cu
    python3 scripts/env_tick_phase_probe.py --design tile --src gym_rotor_tpu_torch/kernels/csrc/env_tick.cu

``--design thread``: ``--src`` is the one-thread-per-env ``env_tick.cu`` of
commit ``dccf3b3`` (``git archive dccf3b3`` into a git-ignored directory);
the marks go in at the anchors of ``MARKS``, and three variants are built
with this tree's generated header (the layout is the same): the source as
it is, the same under ``-fmad=true``, the marked copy.  Per phase, the
median cycles over warps: loads, get_desired, the action map, the
integrator, the polar or exact_so3 step, the errors, the obs,
reward/done, the override, then the tail (the fresh episode and the
stores), split into warps with and without an ended episode.

``--design tile``: ``--src`` is this tree's tile design (the anchors of
``TILE_MARKS``); the source as it is and the marked copy.  Per phase, the
median cycles over blocks of its first tick lane (copy in, the tick warps'
barrier, get_desired, the action map, the integrator, the rest of the
step, the override, the stores, the block's barrier, copy out) and of the
fresh warp's first lane, and when the fresh warp starts and reaches the
barrier against the tick lane.

Both run the decoupled RK4 and DOP853 instances in mode 0 at 4096 and 32
train envs (the tile design also RK4 at 1), on a state 50 plain ticks from
a reset with ~10% of envs one tick from the cap, and print one JSON line
per case: each variant's device time per launch (``chip_smoke.device_ms``),
the cycles, the registers ``-Xptxas -v`` reports and the SASS instructions
``cuobjdump`` counts; then the card's name and power limit.  A mark waits
for the phase's last values before reading the clock, so a phase's cycles
include their latency; the compiler may still move independent work
across a mark.
"""
import argparse
import json
import os
import re
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NPH = 16
MAX_THREADS = 32768
PHASES = ("loads", "get_desired", "action", "integrator", "polar_or_exact",
          "errors", "obs", "reward_done", "override")
# (anchor in the source, text inserted after it[, the anchor's tail the
# text goes before])
MARKS = (
    ('#include "env_tick_layout.h"\n',
     "__device__ long long k1_trace[%d * %d];\n"
     "#define K1_PH(k) do { asm volatile(\"\" ::: \"memory\"); "
     "k1_trace[(size_t)(blockIdx.x * blockDim.x + threadIdx.x) * %d + (k)] "
     "= clock64(); } while (0)\n"
     "#define K1_USE(v) do { unsigned u_; asm volatile(\"mov.b32 %%0, %%1;\" "
     ": \"=r\"(u_) : \"r\"(__float_as_uint(v)) : \"memory\"); } while (0)\n"
     "#define K1_USE3(p) do { K1_USE((p)[0]); K1_USE((p)[1]); "
     "K1_USE((p)[2]); } while (0)\n" % (MAX_THREADS, NPH, NPH)),
    ("  if (i >= a.B) return;\n", "  K1_PH(0);\n"),
    ("  load_traj(a, i, s);\n",
     "  for (int k_ = 0; k_ < 18; ++k_) K1_USE(y[k_]);\n"
     "  K1_USE3(s.xd); K1_USE3(s.b1d); K1_USE(s.t);\n  K1_PH(1);\n"),
    ("              TrajU{u[D_THETA], u[D_HOVER_T], u[D_HOVER_W]});\n",
     "  K1_USE3(s.Wd); K1_USE3(s.xd); K1_USE3(s.b1d);\n  K1_PH(2);\n"),
    ("  T::action(P, act, y + 6, y + 15, o.f, o.M);\n",
     "  K1_USE(o.f); K1_USE3(o.M);\n  K1_PH(3);\n"),
    ("  integrate<INTEG>(y, o.f, o.M, P.m, P.J);\n",
     "  for (int k_ = 0; k_ < 18; ++k_) K1_USE(y[k_]);\n  K1_PH(4);\n"),
    ("  read_R<EXACT>(y + 6, Rr);\n",
     "  for (int k_ = 0; k_ < 9; ++k_) { K1_USE(Rr[k_]); K1_USE(y[6 + k_]); }\n"
     "  K1_PH(5);\n"),
    ("               sf[FIDX(ENV_EIB1, 0)], sf[FIDX(ENV_EIB1_INTEGRAND, 0)], o.n);\n  }\n",
     "  K1_USE3(o.n.ex); K1_USE3(o.n.eIx_norm); K1_USE(o.n.eb1_norm);\n"
     "  K1_USE(o.n.eIb1_norm); K1_USE3(o.n.eW);\n  K1_PH(6);\n"),
    ("  T::build_obs(n, Rr, obs);\n",
     "  for (int k_ = 0; k_ < Task<TASK>::NOBS; ++k_) K1_USE(obs[k_]);\n"
     "  K1_PH(7);\n"),
    ("  T::observe(a.c, y, Rr, g, o.n, o.obs, o.rew, o.d, o.ex, o.eb1);\n",
     "  for (int k_ = 0; k_ < T::NA; ++k_) K1_USE(o.rew[k_]);\n  K1_PH(8);\n"),
    ("  outb[(size_t)T::RESET * B + i] = over;\n", "  K1_PH(9);\n"),
    ("    fresh_episode<TASK, EXACT>(a, i, u);\n    return;\n",
     "    K1_PH(10);\n", "    return;\n"),
    ("  write_obs<TASK>(outf, B, i, T::OBS1, T::OBS2, o.obs);\n}\n\n"
     "template <int TASK, int INTEG, bool EXACT>\n__global__",
     "  K1_PH(11);\n", "}\n\ntemplate <int TASK, int INTEG, bool EXACT>\n__global__"),
    ("      tick<TASK, INTEG, EXACT>(a, i, u);\n", "    K1_PH(12);\n"),
)
# The same for the tile design (this tree's env_tick.cu, --design tile):
# per block, thread 0 (a tick lane) and thread 128 (the fresh warp's lane 0)
TILE_MARKS = (
    MARKS[0],
    ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
     "  K1_PH(0);\n"),
    ("    scatter(du, [&](int q, int, float v) { sm.draws[q] = v; });\n",
     "    K1_PH(1);\n"),
    ("      tick_barrier();\n", "      K1_PH(2);\n"),
    ("    const int i = tid - kTickThreads;\n", "    K1_PH(2);\n"),
    ("      tick_lane<TASK, INTEG, EXACT>(t, i, tid % kLanes, &sm.over[i]);\n",
     "      K1_PH(3);\n"),
    ("    fresh_episode<TASK, EXACT>(t, i, a.draws + (size_t)(i0 + i) * N_DRAWS);\n",
     "    K1_PH(3);\n"),
    ("  __syncthreads();\n\n  // ---- out: per env", "  K1_PH(4);\n",
     "\n  // ---- out: per env"),
    ("    K1_OUT(COUPLED)\n}\n\n// The step and reset entries", "  K1_PH(5);\n",
     "}\n\n// The step and reset entries"),
    ("              TrajU{u[D_THETA], u[D_HOVER_T], u[D_HOVER_W]});\n",
     "  K1_USE3(s.Wd);\n  K1_PH(6);\n"),
    ("                                     o, lk);\n",
     "  K1_USE(o.rew[0]);\n  K1_PH(7);\n"),
    ("  __syncwarp();\n  store_stepped<TASK>(a, i, y, o, t_new);\n",
     "  K1_PH(8);\n", "  __syncwarp();\n  store_stepped<TASK>(a, i, y, o, t_new);\n"),
    ("  if constexpr (SPLIT)\n    integrate_split", "  K1_PH(9);\n",
     "  if constexpr (SPLIT)\n    integrate_split"),
    ("    integrate<INTEG>(y, o.f, o.M, P.m, P.J);\n",
     "  for (int k_ = 0; k_ < 18; ++k_) K1_USE(y[k_]);\n  K1_PH(10);\n"),
)
# tick thread (the tick entry): in 0-1, the tick warps' barrier 1-2,
# get_desired 2-6, action 6-9,
# integrator 9-10, rest of the step 10-7, override and outputs 7-8, stored
# 8-3, barrier 3-4, out 4-5; fresh thread: start 0-2, fresh 2-3, barrier
# 3-4, out 4-5
TILE_TICK = (("in", 0, 1), ("barrier_in", 1, 2), ("get_desired", 2, 6),
             ("action", 6, 9), ("integrator", 9, 10), ("step_rest", 10, 7),
             ("override", 7, 8), ("stores", 8, 3), ("barrier_out", 3, 4),
             ("out", 4, 5), ("total", 0, 5))
TILE_FRESH = (("start", 0, 2), ("fresh", 2, 3),
              ("barrier_out", 3, 4), ("out", 4, 5), ("total", 0, 5))


# the marks 9 -> 10 (fresh episode, ended envs) and 9 -> 11 (stores,
# continuing envs); 12 is the warp's end
TAIL_FRESH, TAIL_STORES, END = 10, 11, 12


def marked_source(text: str, marks=MARKS) -> str:
    for anchor, ins, *tail in marks:
        if text.count(anchor) != 1:
            raise ValueError(f"anchor not found once in --src: {anchor!r}")
        if tail:
            head = anchor[:len(anchor) - len(tail[0])]
            assert head + tail[0] == anchor
            text = text.replace(anchor, head + ins + tail[0])
        else:
            text = text.replace(anchor, anchor + ins)
    return text + ("\nextern \"C\" int k1_trace_read(void* dst, size_t n) {\n"
                   "  return (int)cudaMemcpyFromSymbol(dst, k1_trace, n);\n}\n")


def sources(src: Path, work: Path, design="thread"):
    from gym_rotor_tpu_torch.kernels import build
    from gym_rotor_tpu_torch.kernels import env_tick as K

    class PathSource(build.KernelSource):
        def __init__(self, name, path, flags):
            super().__init__(name, flags, K.layout_header)
            self.path = Path(path)

        @property
        def source(self):
            return self.path

    work.mkdir(parents=True, exist_ok=True)
    marked = work / "env_tick_marked.cu"
    marks = MARKS if design == "thread" else TILE_MARKS
    marked.write_text(marked_source(src.read_text(), marks))
    out = {"as_is": PathSource(f"k1probe_{design}_asis", src, ["-fmad=false"]),
           "marked": PathSource(f"k1probe_{design}_marked", marked,
                                ["-fmad=false"])}
    if design == "thread":
        out["fmad_true"] = PathSource("k1probe_fmad", src, ["-fmad=true"])
    return out


def registers(ptxas):
    out, cur = {}, None
    for ln in ptxas.splitlines():
        m = re.search(r"env_(?:tick|tile)_kernelILi(\d+)ELi(\d+)ELb([01])E",
                      ln)
        if "Compiling entry function" in ln and m:
            cur = m.groups()
        elif cur and "registers" in ln:
            out[cur] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def sass_counts(lib_path):
    """Static SASS instructions per ``env_tick_kernel`` instance of a built
    library (``cuobjdump -sass``), keyed as ``registers``; {} without
    ``cuobjdump``."""
    import shutil
    import subprocess
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return {}
    text = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : .*env_(?:tick|tile)_kernelILi(\d+)ELi(\d+)"
                      r"ELb([01])E", ln)
        if m:
            cur = m.groups()
            out[cur] = 0
        elif "Function :" in ln:
            cur = None
        elif cur and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", ln):
            out[cur] += 1
    return out


def state_for(cfg, dev, n, gen):
    import chip_smoke as cs
    from gym_rotor_tpu_torch.envs.batch import batched_reset_plain
    from gym_rotor_tpu_torch.kernels import env_tick as K
    actions, uniforms = cs._tick_inputs(cfg, dev, n, gen)
    st, _ = batched_reset_plain(cfg, uniforms(), "train")
    for _ in range(50):
        st, _ = K.env_tick_plain(cfg, st, actions(), uniforms(), "train")
    idx = torch.randperm(n, generator=gen, device=dev)[: max(1, n // 10)]
    st.env.t[idx] = cfg.max_steps - 1
    return st, actions(), uniforms()


def breakdown(trace, over, n, cyc_per_us):
    """Median cycles per phase over warps (lane 0's marks), and the tail
    per warp kind."""
    t = trace[:n].astype(np.int64)
    rows = []
    for w in range(0, n, 32):
        lanes = slice(w, min(n, w + 32))
        lt, lo = t[lanes], over[lanes]
        d = {p: int(lt[0, k + 1] - lt[0, k]) for k, p in enumerate(PHASES)}
        d["tail"] = int(lt[0, END] - lt[0, 9])
        d["total"] = int(lt[0, END] - lt[0, 0])
        d["any_ended"] = bool(lo.any())
        if lo.any():
            d["fresh_from_override"] = int(lt[lo, TAIL_FRESH].max()
                                           - lt[0, 9])
        if (~lo).any():
            d["stores_from_override"] = int(lt[~lo, TAIL_STORES].max()
                                            - lt[0, 9])
        rows.append(d)

    def med(key, sel=lambda r: True):
        v = [r[key] for r in rows if sel(r) and key in r]
        return statistics.median(v) if v else None
    out = {p: med(p) for p in PHASES}
    out["tail_warps_with_ended_env"] = med("tail", lambda r: r["any_ended"])
    out["tail_warps_without"] = med("tail", lambda r: not r["any_ended"])
    out["fresh_from_override"] = med("fresh_from_override")
    out["stores_from_override"] = med("stores_from_override")
    out["total_median"] = med("total")
    out["total_max"] = max(r["total"] for r in rows)
    out["warps"] = len(rows)
    out["warps_with_ended_env"] = sum(r["any_ended"] for r in rows)
    out["us_per_kcycle"] = 1e3 / cyc_per_us
    return out


def tile_breakdown(trace, B, cyc_per_us):
    """Median cycles per phase over the blocks of a tile launch: thread 0
    (a tick lane) and thread 128 (the fresh warp's first lane)."""
    blocks = -(-B // 32)
    t = trace[: blocks * 160].astype(np.int64).reshape(blocks, 160, NPH)
    out = {}
    for who, tid, phases in (("tick", 0, TILE_TICK), ("fresh", 128,
                                                     TILE_FRESH)):
        for name, a, b in phases:
            out[f"{who}_{name}"] = statistics.median(
                int(t[k, tid, b] - t[k, tid, a]) for k in range(blocks))
    # when the fresh warp's first lane starts and reaches the block's
    # barrier, against the first tick lane's (the same SM's clock)
    for name, k_ in (("fresh_start_after_tick", 0), ("fresh_at_barrier_after_tick", 3)):
        out[name] = statistics.median(
            int(t[b, 128, k_] - t[b, 0, k_]) for b in range(blocks))
    out["us_per_kcycle"] = 1e3 / cyc_per_us
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, type=Path)
    ap.add_argument("--design", choices=("thread", "tile"), default="thread",
                    help="the source's design: one thread an env (the marks "
                         "of MARKS) or the 32-env tiles (TILE_MARKS)")
    ap.add_argument("--work", type=Path,
                    default=Path(ROOT) / "gym_rotor_tpu_torch" / "kernels"
                    / "build" / "phase_probe",
                    help="where the marked copy of the source is written")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("env_tick_phase_probe: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gym_rotor_tpu_torch.kernels import build
    from gym_rotor_tpu_torch.kernels import env_tick as K
    from gym_rotor_tpu_torch.utils.config import Config
    dev = torch.device("cuda", 0)
    srcs = sources(args.src, args.work, args.design)
    build.build_all(list(srcs.values()))
    regs = {k: registers(s.ptxas) for k, s in srcs.items()}
    sass = {k: sass_counts(s.lib_path()[0]) for k, s in srcs.items()}
    cyc_per_us = cs._cycles_per_ms() / 1e3
    card = cs.gpu_name_power()
    own = K.KERNEL
    cases = [(integ, n) for integ in ("rk4", "dop853") for n in (4096, 32)]
    if args.design == "tile":
        cases.append(("rk4", 1))
    for integ, n in cases:
        cfg = Config(num_envs=n, integrator=integ)
        gen = torch.Generator(device=dev).manual_seed(11)
        st, a, dr = state_for(cfg, dev, n, gen)
        ins, outs = K.pack_state(st), K.empty_bufs(n, dev)
        rec = {"instance": K.instance(cfg), "mode": 0, "envs": n}

        def run():
            return K.env_tick_bufs(cfg, ins, a, dr, "train", outs)
        try:
            for name, s_ in srcs.items():
                K.KERNEL = s_
                rec[f"ms_{name}"] = cs.device_ms(run, 200)[0]
            K.KERNEL = srcs["marked"]
            out = run()
            torch.cuda.synchronize()
            buf = np.zeros(MAX_THREADS * NPH, np.int64)
            lib = K._lib()
            lib.k1_trace_read.argtypes = [K.ctypes.c_void_p,
                                          K.ctypes.c_size_t]
            err = lib.k1_trace_read(buf.ctypes.data, buf.nbytes)
            if err:
                raise RuntimeError(f"k1_trace_read: {err}")
            if args.design == "tile":
                rec["cycles"] = tile_breakdown(buf.reshape(-1, NPH), n,
                                               cyc_per_us)
            else:
                over = out.reset_happened.cpu().numpy()
                rec["cycles"] = breakdown(buf.reshape(-1, NPH), over, n,
                                          cyc_per_us)
        finally:
            K.KERNEL = own
        key = ("0", str(K.INTEGRATORS[integ]), "0")
        rec["registers"] = {k: r.get(key) for k, r in regs.items()}
        rec["sass_instructions"] = {k: c.get(key) for k, c in sass.items()}
        rec["card"] = card
        print(json.dumps(rec), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
