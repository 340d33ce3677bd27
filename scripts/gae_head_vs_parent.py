"""K12 (GAE) and the MLP PPO actor's acting forward of this tree beside an
earlier commit's, on one CUDA device.

    python3 scripts/gae_head_vs_parent.py --parent DIR [--sweep]

``DIR`` is a checkout of the earlier commit (``git archive`` into a
git-ignored directory of the repo).  Its ``gym_rotor_tpu_torch`` package is
imported under another name, so its own wrappers, its own ``gae.cu`` and
``emlp_actor.cu`` (built from ``DIR``) and its own ``ActorPPO`` serve its
side.  Both sides get the same inputs:

- K12 at PPO A's (218, 32), PPO B's (50, 4096) and (1, 7), with ~5% dones,
  and at (7000, 1): ``td`` bitwise the earlier commit's, the normalised
  advantages within 1e-5 max(1, max |plain|) of the plain twin, a rerun
  bitwise.
- The MLP PPO actor (Mod-MLP agents 0 and 1, Mono-MLP: 15 / 16 / 4, 3 / 4
  / 1 and 23 / 16 / 4) at 1, 10, 32 and 4096 rows, with a draw and without
  (eval), ``log_std`` at 0.3: this tree's one launch vs its plain twin
  (1e-5 on actions, 2e-5 max(1, max |plain|) on log-probs), the earlier
  commit's chain (``actor_ppo_pre``'s three ``F.linear`` and two ``relu``,
  then its ``ppo_head`` launch) within the same of the twin; reruns
  bitwise.

Then every case of the first three horizons and of the actor is timed in
turns (earlier, this tree, this tree, earlier) with ``chip_smoke.device_ms``,
its kernels' traced device time taken with ``chip_smoke.kernel_ms``, and the
CUDA kernels one call launches are counted from a ``torch.profiler`` trace
on both sides.  ``--sweep`` also times K12 at other launch plans (at
(218, 32) one CTA of 32-512 threads, one cluster of 16, 8 or 4 CTAs, a
grid of 32 or 8; at (50, 4096) a grid of CTAs of 32, 64 or 128 columns
and one cluster of 16 or 8 CTAs) and holds each to the chosen plan's
outputs.
Prints one JSON line per check and per timing, the cases where this tree
is slower beyond the spread of the two turns, and the card's name and
power limit.  Exits 1 if any output disagrees or a call of this tree
launches other than one kernel.
"""
import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

GAE_TIMED = ((218, 32), (50, 4096), (1, 7))
GAE_CHECKED = GAE_TIMED + ((7000, 1),)
ACTOR_SHAPES = ((15, 16, 4), (3, 4, 1), (23, 16, 4))
ACTOR_ROWS = (1, 10, 32, 4096)


def gae_inputs(T, B, dev, gen):
    v, nv, r = (torch.randn(T, B, 1, generator=gen, device=dev)
                for _ in range(3))
    d = (torch.rand(T, B, 1, generator=gen, device=dev) < 0.05).float()
    return v, nv, r, d


def gae_case(CS, K, PK, T, B, dev, gen, cfg):
    from optim_loss_vs_parent import same
    args = (*gae_inputs(T, B, dev, gen), cfg.discount, cfg.GAE_lambda)
    ak, tk = K.gae(*args)
    ak2, tk2 = K.gae(*args)
    ap_, tp_ = PK.gae(*args)
    ap, tp = K.gae_plain(*args)
    torch.cuda.synchronize()
    err = float((ak - ap).abs().max())
    tol = 1e-5 * max(1.0, float(ap.abs().max()))
    rec = dict(kernel="gae", T=T, B=B, plan=list(K.gae_plan(T, B)),
               td_bitwise_parent=same([tk], [tp_]),
               rerun_bitwise=same([ak, tk], [ak2, tk2]),
               adv_err_vs_plain=err, tol=tol,
               td_err_vs_plain=float((tk - tp).abs().max()),
               parent_adv_err_vs_plain=float((ap_ - ap).abs().max()))
    rec["ok"] = (rec["td_bitwise_parent"] and rec["rerun_bitwise"]
                 and err <= tol and bool(torch.isfinite(ak).all()))
    return rec, args


def actor_pair(mlp, pmlp, dims, dev, seed):
    """This tree's ``ActorPPO`` of ``dims`` from a seed (``log_std`` 0.3)
    and the earlier commit's with the same parameters."""
    nin, nh, nact = dims
    gen = torch.Generator().manual_seed(seed)
    mine = mlp.ActorPPO(nin, nh, nact, device="cpu", generator=gen)
    with torch.no_grad():
        mine.log_std.fill_(0.3)
    theirs = pmlp.ActorPPO(nin, nh, nact, device="cpu")
    theirs.load_state_dict(mine.state_dict())
    return mine.to(dev), theirs.to(dev)


def actor_case(KM, mine, theirs, dims, rows, noisy, dev, gen):
    from optim_loss_vs_parent import same
    nin, _, nact = dims
    obs = 0.6 * torch.randn(rows, nin, generator=gen, device=dev)
    noise = (torch.randn(rows, nact, generator=gen, device=dev) if noisy
             else None)
    with torch.no_grad():
        ak, lk = mine(obs, noise)
        ak2, lk2 = mine(obs, noise)
        ap_, lp_ = theirs(obs, noise)
        ap, lp = KM.mlp_ppo_actor_plain(mine, obs, noise)
    torch.cuda.synchronize()
    tol_l = 2e-5 * max(1.0, float(lp.abs().max()))
    errs = dict(action=float((ak - ap).abs().max()),
                logp=float((lk - lp).abs().max()),
                parent_action=float((ap_ - ap).abs().max()),
                parent_logp=float((lp_ - lp).abs().max()))
    rec = dict(kernel="mlp_ppo_actor", dims=list(dims), rows=rows,
               mode="train" if noisy else "eval", err_vs_plain=errs,
               tol=[1e-5, tol_l], rerun_bitwise=same([ak, lk], [ak2, lk2]),
               clipped=float((ap.abs() == 1.0).float().mean()))
    rec["ok"] = (rec["rerun_bitwise"] and errs["action"] <= 1e-5
                 and errs["logp"] <= tol_l and errs["parent_action"] <= 1e-5
                 and errs["parent_logp"] <= tol_l
                 and bool(torch.isfinite(ak).all() and torch.isfinite(lk).all()))
    out = torch.empty(rows, nact, device=dev)
    lpo = torch.empty(rows, nact, device=dev)

    def call_mine():
        mine(obs, noise, out, lpo)

    def call_theirs():
        theirs(obs, noise, out, lpo)
    return rec, call_theirs, call_mine


def sweep(CS, K, dev, gen, cfg):
    """K12 at other launch plans than the chosen one, each held to the
    chosen plan's outputs (td bitwise, the advantages within 1e-5 max(1,
    max abs): the sums' order follows the plan)."""
    from optim_loss_vs_parent import same
    plans = {
        (218, 32): [dict(mode="solo", threads=t) for t in (32, 64, 128, 256,
                                                           512)]
        + [dict(mode="cluster", cols=c, threads=t) for c in (2, 4, 8)
           for t in (64, 128, 256)]
        + [dict(mode="grid", cols=c, threads=t) for c in (1, 4)
           for t in (64, 128)],
        (50, 4096): [dict(mode="grid", cols=c, threads=t)
                     for c in (32, 64, 128) for t in (128, 256)
                     if t >= c]
        + [dict(mode="cluster", cols=256, threads=256),
           dict(mode="cluster", cols=512, threads=512)],
    }
    bad = []
    for (T, B), alts in plans.items():
        v, nv, r, d = gae_inputs(T, B, dev, gen)
        ref_a, ref_t = K.gae(v, nv, r, d, cfg.discount, cfg.GAE_lambda)
        chosen = K.gae_plan(T, B)
        for kw in [{}] + alts:
            plan = K.gae_plan(T, B, **kw) if kw else chosen
            adv = torch.empty_like(v)
            td = torch.empty_like(v)

            def call():
                K.gae_launch(v, nv, r, d, cfg.discount, cfg.GAE_lambda, adv,
                             td, plan)
            rec = dict(sweep="gae", T=T, B=B, plan=list(plan),
                       chosen=plan == chosen)
            try:
                call()
                torch.cuda.synchronize()
            except RuntimeError as e:
                rec["error"] = str(e)
                print(json.dumps(rec), flush=True)
                continue
            rec["td_bitwise"] = same([td], [ref_t])
            rec["adv_err"] = float((adv - ref_a).abs().max())
            rec["ms"] = CS.device_ms(call, 200)[0]
            rec["traced_ms"] = CS.kernel_ms(call, 50)[0]
            if not (rec["td_bitwise"] and rec["adv_err"]
                    <= 1e-5 * max(1.0, float(ref_a.abs().max()))):
                bad.append(rec)
            print(json.dumps(rec), flush=True)
    return bad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="checkout of the earlier commit")
    ap.add_argument("--sweep", action="store_true",
                    help="also time K12 at other launch plans")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from actor_spectral_vs_parent import parent_package
    from optim_loss_vs_parent import clocks, timed
    from gym_rotor_tpu_torch.kernels import build
    from gym_rotor_tpu_torch.kernels import flat_adamw as K6
    from gym_rotor_tpu_torch.kernels import gae as K
    from gym_rotor_tpu_torch.kernels import mlp_ppo_actor as KM
    from gym_rotor_tpu_torch.models import mlp
    from gym_rotor_tpu_torch.utils.config import PPO_CONFIGS, Config
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = CS.gpu_name_power()
    parent = parent_package(args.parent)
    PK, PKA, pmlp = (parent("kernels.gae"), parent("kernels.emlp_actor"),
                     parent("models.mlp"))
    build.build_all([PK.KERNEL, PKA.KERNEL, K.KERNEL, KM.KERNEL, K6.KERNEL])
    for src in (K.KERNEL, KM.KERNEL):
        print(json.dumps(dict(build=src.name, seconds=src.build_seconds,
                              ptxas=src.resources())), flush=True)
    cfg = Config(**PPO_CONFIGS["A"])
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 13)
    bad, slower = [], []
    clocks()
    for blocks, threads in ((1, 32), (1, 256)):
        ms = CS.device_ms(lambda: K6.empty_launch(blocks, threads, 1, dev),
                          200)[0]
        print(json.dumps(dict(kernel="empty", blocks=blocks, threads=threads,
                              ms=ms)), flush=True)

    for T, B in GAE_CHECKED:
        rec, a = gae_case(CS, K, PK, T, B, dev, gen, cfg)
        if (T, B) in GAE_TIMED:
            rec.update(timed(CS, lambda: PK.gae(*a), lambda: K.gae(*a)))
            rec["kernels_a_call"] = CS.launches_per_call(lambda: K.gae(*a))
            rec["parent_kernels_a_call"] = CS.launches_per_call(
                lambda: PK.gae(*a))
            if rec["kernels_a_call"] != 1:
                rec["ok"] = False
            if rec["slower"]:
                slower.append(rec)
        print(json.dumps(rec), flush=True)
        if not rec["ok"]:
            bad.append(rec)

    for k, dims in enumerate(ACTOR_SHAPES):
        mine, theirs = actor_pair(mlp, pmlp, dims, dev, CS.SEED + k)
        for rows in ACTOR_ROWS:
            for noisy in (True, False):
                rec, theirs_fn, mine_fn = actor_case(KM, mine, theirs, dims,
                                                     rows, noisy, dev, gen)
                if noisy:
                    with torch.no_grad():
                        rec.update(timed(CS, theirs_fn, mine_fn))
                        rec["kernels_a_call"] = CS.launches_per_call(mine_fn)
                        rec["parent_kernels_a_call"] = CS.launches_per_call(
                            theirs_fn)
                    if rec["kernels_a_call"] != 1:
                        rec["ok"] = False
                    if rec["slower"]:
                        slower.append(rec)
                print(json.dumps(rec), flush=True)
                if not rec["ok"]:
                    bad.append(rec)
    if args.sweep:
        bad += sweep(CS, K, dev, gen, cfg)
    clocks()
    print(json.dumps({"disagreeing": bad}), flush=True)
    print(json.dumps({"slower_than_parent": slower}), flush=True)
    print(card, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
