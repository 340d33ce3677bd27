"""K6 (the flat clip + AdamW + Polyak step) and K13 (PPO's surrogate,
forward and backward) of this tree beside an earlier commit's, on one CUDA
device.

    python3 scripts/optim_loss_vs_parent.py --parent DIR [--sweep]

``DIR`` is a checkout of the earlier commit (``git archive`` into a
git-ignored directory of the repo).  Its ``gym_rotor_tpu_torch`` package is
imported under another name, so its own wrappers and its own
``flat_adamw.cu`` and ``ppo_loss.cu`` (built from ``DIR``) serve its side.
Both sides get the same inputs:

- K6 at every flat size the TD3 flagship and PPO A step (and the edge
  sizes 1, 255, 256, 257, the largest network of any learner, and one past
  a pass of the launch plan), with and without Polyak: unclipped (no
  ``max_norm``) and clipped below the clip (gradient norm 10), where the
  outputs do not depend on the norm's summation order, p, mu, nu and the
  target must be bitwise the earlier commit's; clipped above it (norm
  1000), within 1e-6 max(1, max abs) of the plain twin.  Every case's rerun
  is bitwise its first run.
- K13 at 1, 127, 128, 129, 3723 and 20 000 rows of 4 and 1 actions
  (``chip_smoke._k13_inputs``: ratios both sides of the clip range, zero
  advantages, one-action rows exactly at ``1 +- clip_rate``): ``g_mean``
  bitwise the earlier commit's; the loss and ``g_log_std`` within 2e-5 of
  the plain twin's largest entry; reruns bitwise.

Then each case at the path's sizes is timed in turns (earlier, this tree,
this tree, earlier) with ``chip_smoke.device_ms``, its kernels' traced
device time taken with ``chip_smoke.kernel_ms``, and the CUDA kernels one
call launches are counted from a ``torch.profiler`` trace on both sides.
The card's floor for one launch is an empty kernel timed the same way,
launched plain and in clusters.  ``--sweep`` also times K6 and K13 at
other launch plans.  Prints one JSON line
per check and per timing, the cases where this tree is slower beyond the
spread of the two turns, and the card's name and power limit.  Exits 1 if
any output disagrees or a call of this tree launches other than one kernel.
"""
import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

# (path, network, n) of the TD3 flagship's and PPO A's four networks
PATH_SIZES = (("td3", "actor0", 854), ("td3", "critic0", 18704),
              ("td3", "actor1", 122), ("td3", "critic1", 54430),
              ("ppo_a", "actor0", 858), ("ppo_a", "critic0", 9068),
              ("ppo_a", "actor1", 123), ("ppo_a", "critic1", 27092))
EDGE_SIZES = (1, 255, 256, 257, 59104, 262145)
K13_ROWS = (1, 127, 128, 129, 3723, 20000)
K13_TIMED = (128, 3723)


def same(xs, ys):
    return len(xs) == len(ys) and all(
        x.shape == y.shape and bool(torch.equal(x.view(torch.int32),
                                                y.view(torch.int32)))
        for x, y in zip(xs, ys))


def timed(CS, theirs, mine, n=200):
    """Back to back (``device_ms``) in turns, and the kernels' own device
    time a call as a ``torch.profiler`` trace sums it (``kernel_ms``: no
    gap between launches, what ``torch_train_profile.py``'s device time a
    superstep adds up)."""
    p1 = CS.device_ms(theirs, n)[0]
    k1 = CS.device_ms(mine, n)[0]
    k2 = CS.device_ms(mine, n)[0]
    p2 = CS.device_ms(theirs, n)[0]
    return dict(parent_ms=[p1, p2], ms=[k1, k2],
                slower=min(k1, k2) > max(p1, p2),
                parent_traced_ms=CS.kernel_ms(theirs, 50)[0],
                traced_ms=CS.kernel_ms(mine, 50)[0])


def k6_inputs(n, norm, dev, gen):
    def rnd(scale=1.0):
        return scale * torch.randn(n, generator=gen, device=dev)
    g = rnd()
    g *= norm / g.norm()
    return g, rnd(), rnd(1e-2), rnd(1e-3).abs(), rnd()


def k6_case(CS, K, PK, n, kind, polyak, dev, gen):
    """``kind``: unclipped, below (norm 10) or above (norm 1000) the
    clip."""
    from gym_rotor_tpu_torch.algos.common import FlatAdamW, OptState
    from gym_rotor_tpu_torch.utils.config import Config
    cfg = Config(use_clip_grad_norm=kind != "unclipped")
    g, p, mu, nu, tgt = k6_inputs(n, 1000.0 if kind == "above" else 10.0,
                                  dev, gen)
    s = FlatAdamW(cfg, 3e-4).scalars(OptState(7, mu, nu, 7), cfg.tau)
    ps = PK.StepScalars(*(getattr(s, f) for f in s.__dataclass_fields__))
    outs = {}
    for name, fn, sc in (("change", K.flat_adamw, s), ("rerun", K.flat_adamw, s),
                         ("parent", PK.flat_adamw, ps),
                         ("plain", K.flat_adamw_plain, s)):
        bufs = [t.clone() for t in (p, mu, nu, tgt)]
        fn(bufs[0], g, bufs[1], bufs[2], sc, bufs[3] if polyak else None)
        torch.cuda.synchronize()
        outs[name] = bufs if polyak else bufs[:3]
    c = outs["change"]
    err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
              for a, b in zip(c, outs["plain"]))
    bit_parent = same(c, outs["parent"])
    rec = dict(kernel="flat_adamw", n=n, kind=kind, polyak=polyak,
               plan=list(K.flat_adamw_plan(n)),
               bitwise_parent=bit_parent, rerun_bitwise=same(c, outs["rerun"]),
               err_vs_plain=err, tol=1e-6)
    rec["ok"] = (rec["rerun_bitwise"] and err <= 1e-6
                 and (bit_parent or kind == "above"))
    bufs = {k: [t.clone() for t in (p, mu, nu, tgt)] for k in ("p", "c")}
    t = {k: (bufs[k][3] if polyak else None) for k in bufs}

    def theirs():
        PK.flat_adamw(bufs["p"][0], g, bufs["p"][1], bufs["p"][2], ps, t["p"])

    def mine():
        K.flat_adamw(bufs["c"][0], g, bufs["c"][1], bufs["c"][2], s, t["c"])
    return rec, theirs, mine


def k13_case(CS, K, PK, n, act, dev, gen):
    from gym_rotor_tpu_torch.utils.config import Config
    clip = Config().clip_rate
    m, ls, a, lpo, adv, hits = CS._k13_inputs(n, act, clip, gen, dev)
    coef = torch.tensor(0.0097, device=dev)
    g = torch.tensor(1.0, device=dev)
    args = (m, ls, a, lpo, adv, coef, clip)
    res = {}
    for name, mod in (("change", K), ("rerun", K), ("parent", PK)):
        lk = mod.ppo_loss(*args)
        gm, gs = mod.ppo_loss_backward(g, *args)
        torch.cuda.synchronize()
        res[name] = [lk.reshape(1), gm, gs]
    lp = K.ppo_loss_plain(*args)
    gmp, gsp = K.ppo_loss_backward_plain(g, *args)
    c = res["change"]
    errs = {}
    for key, x, y in (("loss", c[0], lp.reshape(1)), ("g_mean", c[1], gmp),
                      ("g_log_std", c[2], gsp)):
        errs[key] = float((x - y).abs().max()) / max(1.0,
                                                     float(y.abs().max()))
    rec = dict(kernel="ppo_loss", rows=n, act=act,
               plan=list(K.ppo_loss_plan(n)),
               rows_at_bound={str(k): v for k, v in hits.items()},
               g_mean_bitwise_parent=same([c[1]], [res["parent"][1]]),
               rerun_bitwise=same(c, res["rerun"]), err_vs_plain=errs,
               tol=2e-5)
    rec["ok"] = (rec["g_mean_bitwise_parent"] and rec["rerun_bitwise"]
                 and max(errs.values()) <= 2e-5
                 and (act != 1 or n < 16 or all(hits.values())))
    return rec, args, g


def empty_floor(CS, K, dev):
    """The card's floor: one empty kernel back to back, plain (1 block of
    32, 1 of 1024, 64 of 864) and in clusters (8 of 256 in one, 16 of 256
    in one, 64 of 864 in clusters of 16)."""
    out = []
    for blocks, threads, cl in ((1, 32, 1), (1, 1024, 1), (64, 864, 1),
                                (8, 256, 8), (16, 256, 16), (64, 864, 16)):
        ms, wall = CS.device_ms(
            lambda: K.empty_launch(blocks, threads, cl, dev), 200)
        rec = dict(kernel="empty", blocks=blocks, threads=threads,
                   cluster=cl, ms=ms, wall_ms_per_call=wall)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def sweep(CS, K, KL, dev, gen):
    """K6 at the path's clipped sizes (Polyak on) and K13 at 128 and 3723
    rows of 4 actions, each at other launch plans than its own (one element
    or row a thread)."""
    from gym_rotor_tpu_torch.algos.common import FlatAdamW, OptState
    from gym_rotor_tpu_torch.utils.config import Config
    cfg = Config()
    lib = K._lib()
    for _, net, n in PATH_SIZES:
        g, p, mu, nu, tgt = k6_inputs(n, 1000.0, dev, gen)
        s = FlatAdamW(cfg, 3e-4).scalars(OptState(7, mu, nu, 7), cfg.tau)
        plans = {K.flat_adamw_plan(n)}
        for T in (128, 256, 512, 1024):
            for C in (1, 8, 16):
                G = -(-n // (C * T))
                if G <= K.MAX_CLUSTERS and (C == 1 or G * C * T - n < C * T):
                    plans.add(K.FlatAdamWPlan(G, C, min(T, 32 * -(-n // 32)),
                                              1))
        for plan in sorted(plans):
            def call():
                err = lib.flat_adamw_launch(
                    p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                    tgt.data_ptr(), n, *plan, s.max_norm, s.b1, 1 - s.b1,
                    s.b2, 1 - s.b2, s.eps, s.wd, s.bc1, s.bc2, s.step, s.tau,
                    1 - s.tau, torch.cuda.current_stream(dev).cuda_stream)
                assert err == 0, err
            print(json.dumps(dict(sweep="flat_adamw", n=n, plan=list(plan),
                                  chosen=plan == K.flat_adamw_plan(n),
                                  ms=CS.device_ms(call, 200)[0])), flush=True)
    llib = KL._lib()
    coef = torch.tensor(0.0097, device=dev)
    g = torch.tensor(1.0, device=dev)
    for B, plans in ((128, ((1, 128, 1), (2, 64, 1), (4, 32, 1))),
                     (3723, ((4, 1024, 1), (8, 512, 1), (16, 256, 1),
                             (1, 1024, 4)))):
        m, ls, a, lpo, adv, _ = CS._k13_inputs(B, 4, 0.2, gen, dev)
        out = torch.empty((), device=dev)
        gm = torch.empty_like(m)
        gs = torch.empty(4, device=dev)
        for plan in plans:
            def fwd():
                assert llib.ppo_loss_fwd_launch(
                    m.data_ptr(), ls.data_ptr(), a.data_ptr(), lpo.data_ptr(),
                    adv.data_ptr(), coef.data_ptr(), B, 4, *plan, 0.8, 1.2,
                    out.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream) == 0

            def bwd():
                assert llib.ppo_loss_bwd_launch(
                    m.data_ptr(), ls.data_ptr(), a.data_ptr(), lpo.data_ptr(),
                    adv.data_ptr(), coef.data_ptr(), g.data_ptr(), B, 4,
                    *plan, 0.8, 1.2, gm.data_ptr(), gs.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream) == 0
            print(json.dumps(dict(sweep="ppo_loss", rows=B, act=4,
                                  plan=list(plan),
                                  chosen=tuple(plan) == KL.ppo_loss_plan(B),
                                  fwd_ms=CS.device_ms(fwd, 200)[0],
                                  bwd_ms=CS.device_ms(bwd, 200)[0])),
                  flush=True)


def clocks():
    """The card's SM clock, its maximum, power draw and temperature."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=30).stdout.strip()
    print(json.dumps({"clocks": out}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="checkout of the earlier commit")
    ap.add_argument("--sweep", action="store_true",
                    help="also time other launch plans")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from actor_spectral_vs_parent import parent_package
    from gym_rotor_tpu_torch.kernels import build
    from gym_rotor_tpu_torch.kernels import flat_adamw as K
    from gym_rotor_tpu_torch.kernels import ppo_loss as KL
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = CS.gpu_name_power()
    parent = parent_package(args.parent)
    PK, PKL = parent("kernels.flat_adamw"), parent("kernels.ppo_loss")
    build.build_all([PK.KERNEL, PKL.KERNEL, K.KERNEL, KL.KERNEL])
    for src in (K.KERNEL, KL.KERNEL):
        print(json.dumps(dict(build=src.name, ptxas=src.resources())),
              flush=True)
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 12)
    bad, slower = [], []
    clocks()
    empty_floor(CS, K, dev)

    timed_sizes = {n for _, _, n in PATH_SIZES}
    for n in sorted(timed_sizes | set(EDGE_SIZES)):
        for kind in ("unclipped", "below", "above"):
            for polyak in (False, True):
                rec, theirs, mine = k6_case(CS, K, PK, n, kind, polyak, dev,
                                            gen)
                if n in timed_sizes and kind != "below":
                    rec.update(timed(CS, theirs, mine))
                    rec["kernels_a_call"] = CS.launches_per_call(mine)
                    rec["parent_kernels_a_call"] = CS.launches_per_call(theirs)
                    if rec["kernels_a_call"] != 1:
                        rec["ok"] = False
                    if rec["slower"]:
                        slower.append(rec)
                print(json.dumps(rec), flush=True)
                if not rec["ok"]:
                    bad.append(rec)

    for n in K13_ROWS:
        for act in (4, 1):
            rec, a, g = k13_case(CS, KL, PKL, n, act, dev, gen)
            if n in K13_TIMED:
                for side, mine, theirs in (
                        ("fwd", lambda: KL.ppo_loss(*a),
                         lambda: PKL.ppo_loss(*a)),
                        ("bwd", lambda: KL.ppo_loss_backward(g, *a),
                         lambda: PKL.ppo_loss_backward(g, *a))):
                    t = timed(CS, theirs, mine)
                    t["kernels_a_call"] = CS.launches_per_call(mine)
                    t["parent_kernels_a_call"] = CS.launches_per_call(theirs)
                    rec[side] = t
                    if t["kernels_a_call"] != 1:
                        rec["ok"] = False
                    if t["slower"]:
                        slower.append(dict(rec, side=side))
            print(json.dumps(rec), flush=True)
            if not rec["ok"]:
                bad.append(rec)
    if args.sweep:
        sweep(CS, K, KL, dev, gen)
    clocks()
    print(json.dumps({"disagreeing": bad}), flush=True)
    print(json.dumps({"slower_than_parent": slower}), flush=True)
    print(card, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
