"""Time the run-time-width EMLP block kernels (K3 ``emlp_block_any``, K4
``emlp_block_backward_any``) of this tree beside an earlier commit's, on one
CUDA device, at the shapes where their time goes: the general EMLP's SO(3)
and S(4) blocks at ``ch`` 384 and 4096 rows (``chip_smoke.py`` phase 28),
the (64, 16) / 256 critic blocks at 256 and 3723 rows and the actor blocks
at 768 rows (phase 26).

    python3 scripts/rt_block_vs_parent.py --parent DIR [--out FILE]

``DIR`` is a checkout of the earlier commit (``git archive`` into a
git-ignored directory of the repo).  Its ``gym_rotor_tpu_torch`` package is
imported under another name, so its own wrappers and plans drive its own
``emlp_block.cu`` (built from ``DIR``); each side builds its own index
from the same nonzeros and gate indices (``BlockSpec.from_index``).  For
each shape and kind (the forward saving lin and pre; the backward with and
without the parameter sums):

- the two sides' outputs compared, bitwise and as max abs difference;
- device ms a call in turns (earlier, this tree, this tree, earlier) with
  ``chip_smoke.device_ms``;
- each side's split: the source rebuilt with a CUDA event recorded before
  and after every launch of its run-time launchers (``marked_source``),
  the wrapper run through that build, the ms of each kernel;
- the CUDA kernels a call (``chip_smoke.launches_per_call``).

Prints one JSON line per (shape, kind), then a summary and the card's name
and power limit; ``--out`` also writes the lines to a file.  Exits 1 if a
side's outputs differ beyond the twins' tolerance (2e-5 max(1, max abs)).
"""
import argparse
import importlib
import importlib.util
import json
import os
import re
import sys
import types
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PARENT_PKG = "parent_gym_rotor_tpu_torch"
ROWS_GENERAL, ROWS_ACTOR = 4096, 768
ROWS_CRITIC = (256, 3723)
SECTION = "// ------------------------------------------------------ " \
          "run-time widths"
MARKS = r'''
static cudaEvent_t rt_ev[64];
static int rt_n = 0;
static void rt_mark(cudaStream_t st) {
  if (rt_n >= 64) return;
  if (!rt_ev[rt_n]) cudaEventCreate(&rt_ev[rt_n]);
  cudaEventRecord(rt_ev[rt_n++], st);
}
extern "C" int rt_marks(float* ms) {
  const int n = rt_n;
  rt_n = 0;
  if (n) cudaEventSynchronize(rt_ev[n - 1]);
  for (int i = 0; i + 1 < n; i += 2)
    cudaEventElapsedTime(ms + i / 2, rt_ev[i], rt_ev[i + 1]);
  return n / 2;
}
'''


def parent_package(root):
    """The earlier commit's ``gym_rotor_tpu_torch``, imported as
    ``PARENT_PKG`` (its modules import each other relatively)."""
    pkg = Path(root) / "gym_rotor_tpu_torch"
    if not (pkg / "__init__.py").exists():
        raise FileNotFoundError(f"--parent: no {pkg}")
    spec = importlib.util.spec_from_file_location(
        PARENT_PKG, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[PARENT_PKG] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{PARENT_PKG}.kernels.emlp_block")


def marked_source(mod, tag):
    """``mod``'s ``emlp_block.cu`` with an event recorded on the stream
    ``st`` before and after each kernel launch of its run-time section and
    ``rt_marks`` exported, written beside the build and wrapped as a
    ``KernelSource`` of the same flags."""
    src = Path(mod.KERNEL.source).read_text()
    head, sec = src.split(SECTION, 1)
    sec = re.sub(r"(\n\s*)(\w+(?:<[^<>;]*>)?\s*<<<.*?>>>\(.*?\);)",
                 r"\1{ rt_mark(st); \2 rt_mark(st); }", sec, flags=re.S)
    text = head.replace("namespace {", MARKS + "\nnamespace {", 1) \
        + SECTION + sec
    base = type(mod.KERNEL)
    path = Path(mod.__file__).parent / "build" / f"emlp_block_marked_{tag}.cu"
    path.parent.mkdir(exist_ok=True)
    path.write_text(text)

    class Marked(base):
        @property
        def source(self):
            return path
    return Marked(f"emlp_block_marked_{tag}", mod.KERNEL.flags)


def split_ms(mod, marked, fn, n=10):
    """Per kernel ms of ``fn`` run through ``marked``'s build of ``mod``."""
    import ctypes
    keep = mod.KERNEL
    mod.KERNEL = marked
    try:
        lib = mod._lib()
        lib.rt_marks.argtypes = [ctypes.c_void_p]
        out = (ctypes.c_float * 64)()
        fn()
        lib.rt_marks(out)
        tot = None
        for _ in range(n):
            fn()
            k = lib.rt_marks(out)
            row = [out[i] for i in range(k)]
            tot = row if tot is None else [a + b for a, b in zip(tot, row)]
        return [t / n for t in tot]
    finally:
        mod.KERNEL = keep


def shapes(dev):
    """``[(label, spec, rows)]``: the general blocks, the (64, 16) / 256
    TD3 critic blocks and the actors' blocks."""
    from gym_rotor_tpu_torch.algos.td3 import TD3Agent
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    from gym_rotor_tpu_torch.models.emlp import general_nn as GN
    from gym_rotor_tpu_torch.models.emlp import groups as GG
    from gym_rotor_tpu_torch.utils.config import Config
    out = []
    for grp, n in (("SO", 3), ("S", 4)):
        G = getattr(GG, grp)(n)
        mid = GN.uniform_rep(384, G)
        blk = types.SimpleNamespace(rep_in=mid, rep_out=mid,
                                    grep=GN.gated(mid))
        out.append((f"general {grp}({n})", K.general_block_spec(blk, dev),
                    ROWS_GENERAL))
    cfg = Config(actor_hidden_dim=(64, 16), critic_hidden_dim=256)
    for i in range(cfg.n_agents):
        a = TD3Agent(cfg, i, dev)
        for blk in a.critic_net.network1.blocks():
            spec = K.block_spec(blk, dev)
            out += [(f"critic {i}", spec, nb) for nb in ROWS_CRITIC]
        for blk in a.actor_net.network.blocks():
            spec = K.block_spec(blk, dev)
            if spec.dims not in K.INSTANCES:
                out.append((f"actor {i}", spec, ROWS_ACTOR))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import chip_smoke as cs
    from gym_rotor_tpu_torch.kernels import emlp_block as K
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.CARD = cs.gpu_name_power()
    PK = parent_package(args.parent)
    marks = {"parent": marked_source(PK, "parent"),
             "change": marked_source(K, "change")}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 20)
    if args.out:
        for tag, mod in (("parent", PK), ("change", K)):
            mod._lib()
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).with_suffix(f".ptxas_{tag}.txt").write_text(
                mod.KERNEL.ptxas)
    lines, bad = [], []
    for label, spec, nb in shapes(dev):
        pspec = PK.BlockSpec.from_index(spec.dims, spec.idx, spec.gate, dev,
                                        runtime_only=True, rows=spec.rows)
        x, W, b, v, g_h = cs._block_operands(spec, nb, gen, dev)
        _, lin, pre = K.emlp_block_any(spec, x, W, b, v)
        sides = {"parent": (PK, pspec), "change": (K, spec)}
        for kind in ("forward", "backward_params", "backward"):
            def call(side, kind=kind):
                mod, sp = sides[side]
                if kind == "forward":
                    return lambda: mod.emlp_block_any(sp, x, W, b, v, True)
                need = kind == "backward_params"
                return lambda: mod.emlp_block_backward_any(
                    sp, g_h, x, W, v, lin, pre, need)
            outs = {s: [t for t in call(s)() if t is not None]
                    for s in sides}
            bitwise = all(torch.equal(a, c) for a, c in
                          zip(outs["parent"], outs["change"]))
            diff = max(float((a - c).abs().max()) / max(
                1.0, float(c.abs().max()))
                for a, c in zip(outs["change"], outs["parent"]))
            if not diff <= 2e-5:
                bad.append((label, spec.dims, nb, kind, diff))
            turns = []
            for side in ("parent", "change", "change", "parent"):
                turns.append(cs.device_ms(call(side), 20)[0])
            rec = dict(shape=label, dims=list(spec.dims), nnz=spec.nnz,
                       rows=nb, kind=kind, bitwise=bitwise, max_rel_diff=diff,
                       parent_ms=[turns[0], turns[3]],
                       change_ms=[turns[1], turns[2]],
                       speedup=(turns[0] + turns[3]) / (turns[1] + turns[2]),
                       parent_split_ms=split_ms(PK, marks["parent"],
                                                call("parent")),
                       change_split_ms=split_ms(K, marks["change"],
                                                call("change")),
                       parent_kernels=cs.launches_per_call(call("parent")),
                       change_kernels=cs.launches_per_call(call("change")),
                       layout=list(spec.rt_layout(
                           "forward" if kind == "forward" else "backward",
                           nb)),
                       card=cs.CARD)
            lines.append(rec)
            print(json.dumps(rec), flush=True)
    slower = [(r["shape"], r["rows"], r["kind"]) for r in lines
              if r["speedup"] < 1.0]
    print(json.dumps({"summary": {
        "shapes": len(lines), "slower": slower, "bad": bad,
        "bitwise_all": all(r["bitwise"] for r in lines)}, "card": cs.CARD}),
        flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in lines))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
