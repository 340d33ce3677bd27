"""Time the run-time-width K7 (``spectral_iterate_any``) and the run-time
acting kernel (``emlp_actor_any``, ``sac_actor_any``, ``ppo_actor_any``:
K3-actor, K9, K11 at any width) of this tree beside an earlier commit's,
on one CUDA device.

    python3 scripts/rt_actor_spectral_vs_parent.py --parent DIR [--out FILE]

``DIR`` is a checkout of the earlier commit (``git archive`` into a
git-ignored directory of the repo).  Its ``gym_rotor_tpu_torch`` package is
imported under another name, so its own wrappers, folds and plans drive its
own ``spectral.cu`` and ``emlp_actor.cu`` (built from ``DIR``).  Shapes:

- K7 at every run-time stack of ``chip_smoke.py`` phase 26's learners
  (critics 128 and 256, TD3 / SAC / PPO) and critic 512's, seeded
  weights of the learners' scale, also timed at each cluster size;
- the acting kernel at the (64, 16) and (128, 32) actors, both agents,
  every head, at 1, 10, 33 and 4096 rows with the draws (the tanh head
  has none) and at 10 rows without them (an eval).

For each: both sides' outputs against the plain twin (K7 1e-5; actions
1e-5, log-probs 2e-5 max(1, max abs)) and against each other; this tree's
rerun bitwise; device ms a call in turns (earlier, this tree, this tree,
earlier) with ``chip_smoke.device_ms``, the plain twin's beside them; the
CUDA kernels a call of each side (``chip_smoke.launches_per_call``); this
tree's plan.  Prints one JSON line per shape, then a summary (the shapes
where this tree is slower, the failures) and the card's name and power
limit; ``--out`` also writes the lines to a file.  Exits 1 on a failure.
"""
import argparse
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PARENT_PKG = "parent_gym_rotor_tpu_torch"
STACKS = ((3, 144, 128), (6, 144, 128), (3, 255, 128), (6, 255, 128),
          (3, 288, 256), (6, 288, 256), (3, 511, 256), (6, 511, 256),
          (6, 568, 512), (6, 1023, 512))
ACTORS = ((64, 16), (128, 32))
ROWS = (1, 10, 33, 4096)
EVAL_ROWS = 10
HEADS = {"tanh": "emlp_actor_any", "gauss": "sac_actor_any",
         "ppo": "ppo_actor_any"}


def parent_package(root):
    """The earlier commit's ``gym_rotor_tpu_torch``, imported as
    ``PARENT_PKG`` (its modules import each other relatively); returns an
    importer of its submodules."""
    pkg = Path(root) / "gym_rotor_tpu_torch"
    if not (pkg / "__init__.py").exists():
        raise FileNotFoundError(f"--parent: no {pkg}")
    spec = importlib.util.spec_from_file_location(
        PARENT_PKG, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[PARENT_PKG] = mod
    spec.loader.exec_module(mod)
    return lambda name: importlib.import_module(f"{PARENT_PKG}.{name}")


def make_actor(zoo, config, ah, agent, head, dev, seed):
    """A seeded MODUL actor of width ``ah`` with ``head``'s class from one
    side's model code (the PPO actor's ``log_std`` at 0.3), so both sides
    fold the same weights."""
    cfg = config.Config(actor_hidden_dim=ah)
    reps = zoo.actor_reps(cfg, "MODUL", agent)
    gen = torch.Generator().manual_seed(seed + agent)
    if head == "tanh":
        actor = zoo.EMLPActorDet(*reps, device="cpu", generator=gen)
    else:
        cls = zoo.EMLPActorSAC if head == "gauss" else zoo.EMLPActorPPO
        actor = cls(*reps, cfg.action_dim_n[agent], device="cpu",
                    generator=gen)
    actor = actor.to(dev)
    if head == "ppo":
        with torch.no_grad():
            actor.log_std.fill_(0.3)
        actor.bump_version()
    return actor


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _err(got, ref):
    """(max abs error, its tolerance 2e-5 max(1, max |ref|))."""
    return (float((got - ref).abs().max()),
            2e-5 * max(1.0, float(ref.abs().max())))


def turns(cs, mine, theirs, plain, n):
    """Device ms in turns: the earlier commit, this tree twice, the earlier
    commit; the plain twin once."""
    p1 = cs.device_ms(theirs, n)[0]
    k1 = cs.device_ms(mine, n)[0]
    k2 = cs.device_ms(mine, n)[0]
    p2 = cs.device_ms(theirs, n)[0]
    return dict(parent_ms=[p1, p2], change_ms=[k1, k2],
                speedup=(p1 + p2) / (k1 + k2),
                plain_ms=cs.device_ms(plain, 5, 3)[0])


def spectral_rows(cs, KS, PKS, dev, gen):
    for K, mo, mi in STACKS:
        Ws = torch.randn(K, mo, mi, generator=gen, device=dev) * mi ** -0.5
        x = torch.randn(K, mi, generator=gen, device=dev)
        mine = lambda: KS.spectral_iterate_any(Ws, x)
        theirs = lambda: PKS.spectral_iterate_any(Ws, x)
        plain = lambda: KS.spectral_iterate_plain(Ws, x)
        got, again, ref, par = mine(), mine(), plain(), theirs()
        err = float((got - ref).abs().max())
        perr = float((par - ref).abs().max())
        ok = err <= 1e-5 and perr <= 1e-5 and torch.equal(got, again) \
            and bool(torch.isfinite(got).all())
        plan = KS.any_plan(K, mo, mi, KS._active(dev, mi))
        by_cluster = {}
        for C in KS.CLUSTER_SIZES:
            KS._FORCE["cluster"] = C
            try:
                by_cluster[C] = [cs.device_ms(mine, 50)[0],
                                 KS.any_plan(K, mo, mi)._asdict()]
            finally:
                KS._FORCE.pop("cluster")
        yield dict(kernel="spectral_iterate_any", stack=[K, mo, mi],
                   ms_by_cluster=by_cluster,
                   max_abs_err=err, parent_max_abs_err=perr,
                   vs_parent=float((got - par).abs().max()),
                   rerun_bitwise=torch.equal(got, again), ok=ok,
                   plan=plan._asdict(), **turns(cs, mine, theirs, plain, 50),
                   change_kernels=cs.launches_per_call(mine),
                   parent_kernels=cs.launches_per_call(theirs))


def actor_rows(cs, KA, PKA, zoo, pzoo, config, pconfig, dev, gen):
    for ah in ACTORS:
        for agent in (0, 1):
            for head, name in HEADS.items():
                a_c = make_actor(zoo, config, ah, agent, head, dev, cs.SEED)
                a_p = make_actor(pzoo, pconfig, ah, agent, head, dev,
                                 cs.SEED)
                f = KA.fold_actor(a_c)
                nin, nact = f["dims"][0], f["dims"][3]
                modes = [(nb, head != "tanh") for nb in ROWS]
                if head != "tanh":
                    modes.append((EVAL_ROWS, False))
                for nb, train in modes:
                    o = torch.randn(nb, nin, generator=gen, device=dev)
                    noise = torch.randn(nb, nact, generator=gen, device=dev) \
                        if train else None
                    args = () if head == "tanh" else (noise,)
                    plain_fn = getattr(KA, name.replace("_any", "_plain"))
                    mine = lambda: getattr(KA, name)(a_c, o, *args)
                    theirs = lambda: getattr(PKA, name)(a_p, o, *args)
                    plain = lambda: plain_fn(a_c, o, *args)
                    with torch.no_grad():
                        got, again = _tuple(mine()), _tuple(mine())
                        ref, par = _tuple(plain()), _tuple(theirs())
                        ea = float((got[0] - ref[0]).abs().max())
                        pa = float((par[0] - ref[0]).abs().max())
                        ok = ea <= 1e-5 and pa <= 1e-5 and all(
                            torch.equal(a, b) for a, b in zip(got, again))
                        el = pl = 0.0
                        if head == "ppo":
                            el, tol = _err(got[1], ref[1])
                            pl, ptol = _err(par[1], ref[1])
                            ok = ok and el <= tol and pl <= ptol
                        ok = ok and all(bool(torch.isfinite(t).all())
                                        for t in got)
                        row = dict(
                            kernel=name, width=list(ah), agent=agent,
                            dims=list(f["dims"]), batch=nb, train=train,
                            max_abs_err=ea, logp_err=el,
                            parent_max_abs_err=pa, parent_logp_err=pl,
                            vs_parent=max(float((a - b).abs().max())
                                          for a, b in zip(got, par)),
                            rerun_bitwise=all(torch.equal(a, b) for a, b
                                              in zip(got, again)), ok=ok,
                            warps=f["warps"], slots=f["slots"],
                            plan=list(KA.any_plan(
                                f["dims"], f["layout"], f["slots"],
                                KA.plan_words(f))),
                            **turns(cs, mine, theirs, plain, 100))
                        row["change_kernels"] = cs.launches_per_call(mine)
                        row["parent_kernels"] = cs.launches_per_call(theirs)
                    yield row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="checkout of the earlier commit")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gym_rotor_tpu_torch.kernels import build
    from gym_rotor_tpu_torch.kernels import emlp_actor as KA
    from gym_rotor_tpu_torch.kernels import spectral as KS
    from gym_rotor_tpu_torch.models.emlp import zoo
    from gym_rotor_tpu_torch.utils import config
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.CARD = cs.gpu_name_power()
    parent = parent_package(args.parent)
    PKA, PKS = parent("kernels.emlp_actor"), parent("kernels.spectral")
    build.build_all([PKA.KERNEL, PKS.KERNEL, KA.KERNEL, KS.KERNEL])
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        for tag, mod in (("parent", PKA), ("change", KA), ("parent", PKS),
                         ("change", KS)):
            out.with_suffix(f".ptxas_{mod.KERNEL.name}_{tag}.txt").write_text(
                mod.KERNEL.ptxas)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    lines = []
    for row in list(spectral_rows(cs, KS, PKS, dev, gen)) + list(actor_rows(
            cs, KA, PKA, zoo, parent("models.emlp.zoo"), config,
            parent("utils.config"), dev, gen)):
        row["card"] = cs.CARD
        lines.append(row)
        print(json.dumps(row), flush=True)
    slower = [(r["kernel"], r.get("stack") or [r["dims"], r["batch"],
                                               r["train"]])
              for r in lines if r["speedup"] < 1.0]
    bad = [r for r in lines if not r["ok"]]
    print(json.dumps({"summary": {"shapes": len(lines), "slower": slower,
                                  "failures": len(bad)}}), flush=True)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in lines))
    print(cs.CARD, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
