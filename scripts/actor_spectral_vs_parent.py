"""Time the acting kernel (K3-actor, K9, K11) and K7 of this tree beside an
earlier commit's, on one CUDA device, at the instances that a run of
``chip_smoke.py`` timed.

    python3 chip_smoke.py > smoke.log
    python3 scripts/actor_spectral_vs_parent.py --parent DIR --log smoke.log

``DIR`` is a checkout of the earlier commit (``git archive`` into a
git-ignored directory of the repo).  Its ``gym_rotor_tpu_torch`` package is
imported under another name, so the earlier commit's own wrappers, its
``fold_actor`` and its kernel sources (built from ``DIR`` into its own
build directory) serve its side, whatever its fold's layout.  Each side's
actors come from its own model code with the same seed, so both fold the
same weights.  ``smoke.log``'s ``[kernels]`` lines of phase 19 name the
instances: the acting kernel by (dims, head, mode, rows), K7 by its stack.
Each instance is timed in turns (earlier, this tree, this tree, earlier)
on the same inputs with ``chip_smoke.device_ms``, and the two sides'
outputs are compared (within 1e-5, the tolerance of each against its
twin).  Prints one JSON line per instance, then per kernel the mean over
its instances, the instances where this tree is slower, and the card's
name and power limit.
"""
import argparse
import importlib
import importlib.util
import json
import os
import sys
from collections import defaultdict
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PARENT_PKG = "parent_gym_rotor_tpu_torch"
ACTOR_KERNELS = ("emlp_actor", "sac_actor", "ppo_actor")
# (framework, agent) of each acting-kernel instance (nin, ng, nh, nact)
AGENT_OF = {(15, 18, 16, 4): ("MODUL", 0), (3, 7, 4, 1): ("MODUL", 1),
            (23, 18, 16, 4): ("MONO", 0)}


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
    return lambda name: importlib.import_module(f"{PARENT_PKG}.{name}")


def make_actor(zoo, config, dims, head, dev, seed):
    """A seeded actor of ``dims`` with ``head``'s class from one side's
    model code (the PPO actor's ``log_std`` at 0.3)."""
    fw, agent = AGENT_OF[tuple(dims)]
    cfg = config.Config(framework=fw)
    reps = zoo.actor_reps(cfg, fw, agent)
    gen = torch.Generator().manual_seed(seed)
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


def instances(log_path):
    """Phase 19's acting-kernel and K7 records in ``log_path``, each
    instance once, with the paths that logged it."""
    out = {}
    for ln in Path(log_path).read_text().splitlines():
        if not ln.startswith("[kernels] "):
            continue
        rec = json.loads(ln[len("[kernels] "):])
        if rec.get("kernel") in ACTOR_KERNELS and "head" in rec:
            key = (rec["kernel"], tuple(rec["dims"]), rec["head"],
                   rec["mode"], rec["batch"])
        elif rec.get("kernel") == "spectral_iterate" and "stack" in rec:
            key = ("spectral_iterate", tuple(rec["stack"]))
        else:
            continue
        out.setdefault(key, {"paths": [], "smoke_ms": rec["ms"]})
        out[key]["paths"].append(rec.get("path"))
    if not out:
        raise ValueError(f"{log_path}: no acting-kernel or K7 records")
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
    from gym_rotor_tpu_torch.kernels import build
    from gym_rotor_tpu_torch.kernels import emlp_actor as KA
    from gym_rotor_tpu_torch.kernels import spectral as KS
    from gym_rotor_tpu_torch.models.emlp import zoo
    from gym_rotor_tpu_torch.utils import config
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = CS.gpu_name_power()
    parent = parent_package(args.parent)
    PKA, PKS = parent("kernels.emlp_actor"), parent("kernels.spectral")
    pzoo, pconfig = parent("models.emlp.zoo"), parent("utils.config")
    build.build_all([PKA.KERNEL, PKS.KERNEL, KA.KERNEL, KS.KERNEL])
    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    actors, sums, bad = {}, defaultdict(list), []
    for key, info in instances(args.log).items():
        if key[0] == "spectral_iterate":
            K, mo, mi = key[1]
            Ws = torch.randn(K, mo, mi, generator=gen, device=dev)
            Ws /= mo ** 0.5
            x = torch.randn(K, mi, generator=gen, device=dev)
            mine = lambda: KS.spectral_iterate(Ws, x)
            theirs = lambda: PKS.spectral_iterate(Ws, x)
            label = {"stack": [K, mo, mi]}
        else:
            kernel, dims, head, mode, nb = key
            if (dims, head) not in actors:
                actors[(dims, head)] = (
                    make_actor(zoo, config, dims, head, dev, CS.SEED),
                    make_actor(pzoo, pconfig, dims, head, dev, CS.SEED))
            a_c, a_p = actors[(dims, head)]
            o = 0.7 * torch.randn(nb, dims[0], generator=gen, device=dev)
            noise = None if mode == "eval" else torch.randn(
                nb, dims[3], generator=gen, device=dev)
            args = () if head == "tanh" else (noise,)
            call = (lambda K_, a: getattr(K_, kernel)(a, o, *args))
            mine = lambda: call(KA, a_c)
            theirs = lambda: call(PKA, a_p)
            label = {"dims": list(dims), "head": head, "mode": mode,
                     "batch": nb}
        with torch.no_grad():
            got, ref = mine(), theirs()
            got_t = got if isinstance(got, tuple) else (got,)
            ref_t = ref if isinstance(ref, tuple) else (ref,)
            diff = max(float((g - r).abs().max())
                       for g, r in zip(got_t, ref_t))
            n, rounds = 200, 5
            p1 = CS.device_ms(theirs, n, rounds)[0]
            k1 = CS.device_ms(mine, n, rounds)[0]
            k2 = CS.device_ms(mine, n, rounds)[0]
            p2 = CS.device_ms(theirs, n, rounds)[0]
        ms, parent_ms = (k1 + k2) / 2, (p1 + p2) / 2
        row = dict(kernel=key[0], **label, paths=info["paths"],
                   parent_ms=parent_ms, ms=ms, smoke_ms=info["smoke_ms"],
                   speedup=parent_ms / ms, max_abs_diff_vs_parent=diff)
        print(json.dumps(row), flush=True)
        sums[key[0]].append((parent_ms, ms))
        if ms > parent_ms or not diff <= 1e-5:
            bad.append(row)
    for kernel, rows in sums.items():
        print(json.dumps({
            "summary": kernel, "instances": len(rows),
            "parent_ms": sum(p for p, _ in rows) / len(rows),
            "ms": sum(m for _, m in rows) / len(rows)}), flush=True)
    print(json.dumps({"slower_than_parent_or_disagreeing": bad}), flush=True)
    print(card, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
