"""Time the EMLP block kernels (K3 forward, K4 backward) of this tree beside
an earlier commit's, on one CUDA device, at the instances that a run of
``chip_smoke.py`` timed.

    python3 chip_smoke.py > smoke.log
    python3 scripts/emlp_block_vs_parent.py --parent DIR --log smoke.log

``DIR`` is a checkout of the earlier commit (``git archive`` into a
git-ignored directory of the repo).  Its
``gym_rotor_tpu_torch/kernels/csrc/emlp_block.cu`` is built beside this
tree's and called through the C interface it had before the redesign: one
thread a row, ``params = [W_eff, b_eff, v]`` and the index's prefix
``gate, rowptr, ji, o`` (which this tree's index keeps), its forward always
writing ``lin`` and ``pre``.  ``smoke.log`` is ``chip_smoke.py``'s output
on this tree: phase 19's ``[kernels]`` lines of ``emlp_block`` and
``emlp_block_backward`` name the instances (path, dims, rows, whether the
forward saves lin/pre or the backward sums the parameter gradients,
launches).  Each instance is timed in turns (earlier, this tree, this tree,
earlier) on the same inputs with ``chip_smoke.device_ms``.  Prints one JSON
line per instance, then per path and kernel the launch-weighted means, the
instances where this tree is slower, and the card's name and power limit.
"""
import argparse
import ctypes
import json
import os
import sys
from collections import defaultdict
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parent_lib(root):
    """The earlier commit's ``emlp_block.cu``, built and typed."""
    from gym_rotor_tpu_torch.kernels.build import KernelSource

    class ParentSource(KernelSource):
        @property
        def source(self):
            return Path(root) / "gym_rotor_tpu_torch/kernels/csrc/emlp_block.cu"

    src = ParentSource("emlp_block_parent", [])
    if not src.source.exists():
        raise FileNotFoundError(f"--parent: no {src.source}")
    lib = src.load()
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.emlp_block_fwd_launch.argtypes = [P, I, P, P, I, P, P, P, I, I, I, P]
    lib.emlp_block_bwd_launch.argtypes = [P, P, I, P, P, I, P, P, P, P, P, I,
                                          I, I, I, P]
    return lib


def parent_forward(lib, spec, x, W, b, v):
    from gym_rotor_tpu_torch.kernels.build import check
    (nin, ng, nh), nb = spec.dims, x.shape[0]
    params = torch.cat([W.reshape(-1), b, v])
    h = x.new_empty(nb, nh)
    lin, pre = x.new_empty(ng, nb), x.new_empty(ng, nb)
    st = torch.cuda.current_stream(x.device).cuda_stream

    def run():
        check(lib.emlp_block_fwd_launch(
            x.data_ptr(), nb, params.data_ptr(), spec.ints.data_ptr(),
            spec.nnz, h.data_ptr(), lin.data_ptr(), pre.data_ptr(), nin, ng,
            nh, st), lib, "earlier emlp_block forward")
    return run


def parent_backward(lib, spec, g_h, x, W, v, lin, pre, need):
    from gym_rotor_tpu_torch.kernels.build import check
    (nin, ng, nh), nb = spec.dims, x.shape[0]
    params = torch.cat([W.reshape(-1), W.new_zeros(ng), v])
    n_par = params.numel()
    g_x = x.new_empty(nb, nin)
    partial = x.new_empty(-(-nb // 32) * n_par if need else 1)
    g_par = x.new_empty(n_par if need else 1)
    st = torch.cuda.current_stream(x.device).cuda_stream

    def run():
        check(lib.emlp_block_bwd_launch(
            g_h.data_ptr(), x.data_ptr(), nb, params.data_ptr(),
            spec.ints.data_ptr(), spec.nnz, lin.data_ptr(), pre.data_ptr(),
            g_x.data_ptr(), partial.data_ptr(), g_par.data_ptr(), int(need),
            nin, ng, nh, st), lib, "earlier emlp_block backward")
    return run


def instances(log_path):
    """Phase 19's K3/K4 records in ``log_path``, in order."""
    out = []
    for ln in Path(log_path).read_text().splitlines():
        if not ln.startswith("[kernels] "):
            continue
        rec = json.loads(ln[len("[kernels] "):])
        if rec.get("kernel") in ("emlp_block", "emlp_block_backward") \
                and "dims" in rec:
            out.append(rec)
    if not out:
        raise ValueError(f"{log_path}: no K3/K4 instance records")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="checkout of the earlier commit")
    ap.add_argument("--log", required=True, help="chip_smoke.py's output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from gym_rotor_tpu_torch.kernels import emlp_block as KB
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = CS.gpu_name_power()
    lib = parent_lib(args.parent)
    specs = CS.block_specs(dev)
    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    sums = defaultdict(lambda: [0, 0.0, 0.0, []])
    for rec in instances(args.log):
        spec, nb = specs[tuple(rec["dims"])], rec["batch"]
        nin, ng, nh = spec.dims
        x = torch.randn(nb, nin, generator=gen, device=dev)
        W = 0.3 * torch.randn(ng, nin, generator=gen, device=dev)
        b = 0.1 * torch.randn(ng, generator=gen, device=dev)
        v = 0.3 * torch.randn(spec.nnz, generator=gen, device=dev)
        if rec["kernel"] == "emlp_block":
            flag = rec["saves_lin_pre"]
            mine = (lambda s=flag: KB.emlp_block(spec, x, W, b, v, s))
            theirs = parent_forward(lib, spec, x, W, b, v)
        else:
            flag = rec["param_grads"]
            _, lin, pre = KB.emlp_block(spec, x, W, b, v)
            g_h = torch.randn(nb, nh, generator=gen, device=dev)
            mine = (lambda n=flag: KB.emlp_block_backward(
                spec, g_h, x, W, v, lin, pre, n))
            theirs = parent_backward(lib, spec, g_h, x, W, v, lin, pre, flag)
        n, rounds = (3, 3) if nb > 32768 else (50, 5)
        p1 = CS.device_ms(theirs, n, rounds)[0]
        k1 = CS.device_ms(mine, n, rounds)[0]
        k2 = CS.device_ms(mine, n, rounds)[0]
        p2 = CS.device_ms(theirs, n, rounds)[0]
        ms, parent_ms = (k1 + k2) / 2, (p1 + p2) / 2
        print(json.dumps({
            "path": rec["path"], "kernel": rec["kernel"],
            "dims": rec["dims"], "batch": nb, "flag": flag,
            "launches": rec["launches"], "parent_ms": parent_ms, "ms": ms,
            "smoke_ms": rec["ms"], "speedup": parent_ms / ms}), flush=True)
        s = sums[(rec["path"], rec["kernel"])]
        s[0] += rec["launches"]
        s[1] += rec["launches"] * parent_ms
        s[2] += rec["launches"] * ms
        if ms > parent_ms:
            s[3].append([rec["dims"], nb, flag, parent_ms, ms])
    for (path, kernel), (w, p, k, slower) in sums.items():
        print(json.dumps({
            "summary": kernel, "path": path, "launches": w,
            "parent_ms": p / w if w else None, "ms": k / w if w else None,
            "slower_than_parent": slower}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
