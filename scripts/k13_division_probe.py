"""K13's backward with and without its zero-numerator guard, on one CUDA
device: what IEEE division's slow path costs the kernel.

    python3 scripts/k13_division_probe.py

``g_mean = g_S z / std`` divides by ``std``; where the numerator is zero (a
zero advantage, or the side of the clip that passes no gradient: about one
row in four of ``chip_smoke._k13_inputs``) the division's range check sends
it down the slow path.  ``csrc/ppo_loss.cu`` skips the division there (a
zero over ``std > 0`` is that zero).  This builds the source as it is, with
every numerator divided (the guard removed) and with no division at all
(``g_S z``: not the function, the time of the rest), each with the
kernels' own flags, and times the backward of each at 128 and 3723 rows of
4 and 1 actions with ``chip_smoke.device_ms``; the forward, which divides
``a - m`` (never zero here), once beside it; the unguarded build's
``g_mean`` must be bitwise the built kernel's.  Prints one JSON line per
case and the card's name and power limit.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GUARD = "if (gm[j] != 0.0f) gm[j] = gm[j] / w.sd[j];"
VARIANTS = {"as_built": GUARD, "divide_every_numerator": "gm[j] = gm[j] / w.sd[j];",
            "no_division": ""}


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from gym_rotor_tpu_torch.kernels import build
    from gym_rotor_tpu_torch.kernels import ppo_loss as KL
    src = (build.CSRC / "ppo_loss.cu").read_text()
    assert GUARD in src, "the guard line moved: update this probe"
    out_dir = build.BUILD_DIR / "k13_division_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, line in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src.replace(GUARD, line))
        procs[name] = subprocess.Popen(
            [build.nvcc()] + build.ARCH + build.BASE_FLAGS + KL.KERNEL.flags
            + ["-I", str(build.CSRC), "-o", str(cu.with_suffix(".so")),
               str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    ref = KL._lib()
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn in ("ppo_loss_fwd_launch", "ppo_loss_bwd_launch"):
            getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 12)
    coef = torch.tensor(0.0097, device=dev)
    g = torch.tensor(1.0, device=dev)
    for B, A in ((128, 4), (3723, 4), (128, 1), (3723, 1)):
        m, ls, a, lpo, adv, _ = CS._k13_inputs(B, A, 0.2, gen, dev)
        ratio = KL._ratio(m, ls, a, lpo)[0]
        gm_ref, _ = KL.ppo_loss_backward_plain(g, m, ls, a, lpo, adv, coef,
                                               0.2)
        gm = torch.empty_like(m)
        gs = torch.empty(A, device=dev)
        out = torch.empty((), device=dev)
        plan = KL.ppo_loss_plan(B)
        st = torch.cuda.current_stream(dev).cuda_stream
        rec = dict(rows=B, act=A, plan=list(plan),
                   zero_numerator_rows=int((gm_ref == 0).all(1).sum()),
                   clipped_rows=int(((ratio < 0.8) | (ratio > 1.2)).sum()))
        for name, lib in libs.items():
            def bwd(lib=lib):
                assert lib.ppo_loss_bwd_launch(
                    m.data_ptr(), ls.data_ptr(), a.data_ptr(), lpo.data_ptr(),
                    adv.data_ptr(), coef.data_ptr(), g.data_ptr(), B, A,
                    *plan, 0.8, 1.2, gm.data_ptr(), gs.data_ptr(), st) == 0
            rec[name + "_bwd_ms"] = CS.device_ms(bwd, 200)[0]
            if name != "no_division":
                torch.cuda.synchronize()
                rec[name + "_g_mean_bitwise_as_built"] = bool(
                    torch.equal(gm.view(torch.int32),
                                KL.ppo_loss_backward(g, m, ls, a, lpo, adv,
                                                     coef, 0.2)[0]
                                .view(torch.int32)))

        def fwd():
            assert ref.ppo_loss_fwd_launch(
                m.data_ptr(), ls.data_ptr(), a.data_ptr(), lpo.data_ptr(),
                adv.data_ptr(), coef.data_ptr(), B, A, *plan, 0.8, 1.2,
                out.data_ptr(), st) == 0
        rec["fwd_ms"] = CS.device_ms(fwd, 200)[0]
        print(json.dumps(rec), flush=True)
    print(CS.gpu_name_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
