"""K1 (the env tick) and K2 write + K8 (the replay ring write with the
episode statistics) of this tree beside an earlier commit's, on one CUDA
device.

    python3 scripts/tick_replay_vs_parent.py --parent DIR [--sizes 1,31,32,33,4096]

``DIR`` is a checkout of the earlier commit (``git archive`` into a
git-ignored directory of the repo).  Its ``gym_rotor_tpu_torch`` package is
imported under another name, so its own wrappers and its own
``env_tick.cu`` and ``replay.cu`` (built from ``DIR`` into its build
directory) serve its side.  Both sides get the same inputs:

- K1: each of the fifteen instances (task x integrator x ``exact_so3``; the
  quad task ``exact_so3`` only), each entry it has (tick, reset and step;
  the quad task step), at every ``--sizes`` row count: a state three plain
  ticks from a reset in mode 0 (mode 3 for the exact instances), ~25% of
  envs one tick from the cap (so the tick's fresh-episode select goes both
  ways), under ``exact_so3`` ~30% of attitudes drifted by 1e-4.  Every
  output buffer (state, obs, reward, flags) must be bitwise the earlier
  commit's, and a rerun of this tree's bitwise its first run.
- K2 write + K8: the flagship's 45-float MODUL rows and the 52-float MONO
  rows at 1, 32, 33 and 4096 rows (those of ``--sizes`` past 1), into a ring
  whose cursor sits three rows before its end, with the statistics and
  without: the ring and ``ep_ret`` bitwise the earlier commit's, the sums
  within 1e-5 max(1, max |sum|) of the plain twin.

Then each (kernel, instance, entry) at 1, 32 and 4096 rows is timed in
turns (earlier, this tree, this tree, earlier) with
``chip_smoke.device_ms``.  Prints one JSON line per check and per timing,
the timings where this tree is slower beyond the spread of the two turns,
and the card's name and power limit.  Exits 1 if any output disagrees.
"""
import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

TIMED = (1, 32, 4096)


def tick_inputs(K, cfg, B, dev, gen):
    """A state (three plain ticks from a reset), actions and draws for
    ``cfg``'s task on ``B`` envs, ~25% one tick from the cap."""
    from gym_rotor_tpu_torch.envs import draws as D
    from gym_rotor_tpu_torch.envs.batch import batched_reset_plain
    n_act = sum(cfg.action_dim_n)

    def actions():
        return 0.3 * torch.randn(B, n_act, generator=gen, device=dev)

    def draws():
        return D.draw_uniforms(B, gen, torch.float32, dev)
    st, _ = batched_reset_plain(cfg, draws(), "train")
    for _ in range(3):
        st, _ = K.env_tick_plain(cfg, st, actions(), draws(), "train")
    idx = torch.randperm(B, generator=gen, device=dev)[: max(1, B // 4)]
    st.env.t[idx] = cfg.max_steps - 1
    if cfg.exact_so3:
        drift = torch.rand(B, generator=gen, device=dev) < 0.3
        st.env.R[drift] += 1e-4 * torch.randn(int(drift.sum()), 3, 3,
                                              generator=gen, device=dev)
    return st, actions(), draws()


def k1_calls(K, cfg, task, entry, st, a, dr):
    """Through module ``K``'s wrappers: ``fn()`` running one launch of
    ``entry`` on the inputs (the step entry on a fresh copy of the env),
    ``get()`` its outputs, and the launch to time (the step entry in place,
    on the env it keeps stepping)."""
    B = a.shape[0]
    if entry == "step":
        env0 = K.pack_env(st.env)
        bufs = tuple(t.clone() for t in env0)
        run = tuple(t.clone() for t in env0)
        res = {}

        def fn():
            for b, b0 in zip(bufs, env0):
                b.copy_(b0)
            res["o"] = K.env_step_bufs(cfg, bufs, a, task)

        def get():
            o = res["o"]
            return list(bufs) + list(o.obs) + [o.reward, o.done, o.info["ex"],
                                               o.info["eb1"]]
        return fn, get, lambda: K.env_step_bufs(cfg, run, a, task)
    ins = K.pack_state(st)
    outs = K.empty_bufs(B, a.device)
    res = {}
    if entry == "tick":
        def fn():
            res["o"] = K.env_tick_bufs(cfg, ins, a, dr, "train", outs)

        def get():
            o = res["o"]
            return list(outs) + list(o.obs) + [
                o.reward, o.done, o.reset_happened, o.info["ex"],
                o.info["eb1"], o.info["crashed"]] + list(
                    o.info["terminal_obs"])
        return fn, get, fn

    def fn():
        res["o"] = K.env_reset(cfg, dr, "train")

    def get():
        from gym_rotor_tpu_torch.utils.tree import tree_named_leaves
        st_o, obs = res["o"]
        return [t for _, t in tree_named_leaves(st_o)] + list(obs)
    return fn, get, fn


def same(xs, ys):
    return len(xs) == len(ys) and all(
        x.shape == y.shape and bool(torch.equal(
            x.view(torch.uint8) if x.dtype != torch.bool else x,
            y.view(torch.uint8) if y.dtype != torch.bool else y))
        for x, y in zip(xs, ys))


def snapshot(get):
    torch.cuda.synchronize()
    return [t.clone() for t in get()]


def timed(CS, theirs, mine, n=100):
    p1 = CS.device_ms(theirs, n)[0]
    k1 = CS.device_ms(mine, n)[0]
    k2 = CS.device_ms(mine, n)[0]
    p2 = CS.device_ms(theirs, n)[0]
    return dict(parent_ms=[p1, p2], ms=[k1, k2],
                slower=min(k1, k2) > max(p1, p2))


def replay_case(KR, PKR, dims, B, dev, gen, with_stats):
    from gym_rotor_tpu_torch.algos import replay as R
    n = len(dims[0])
    cap = max(B + 7, 64)
    ptr = cap - 3
    obs = tuple(torch.randn(B, d, generator=gen, device=dev) for d in dims[0])
    nobs = tuple(torch.randn(B, d, generator=gen, device=dev)
                 for d in dims[0])
    act = torch.rand(B, sum(dims[1]), generator=gen, device=dev) * 2 - 1
    rwd = torch.rand(B, n, generator=gen, device=dev)
    done = torch.rand(B, n, generator=gen, device=dev) < 0.2
    reset = torch.rand(B, generator=gen, device=dev) < 0.2
    ring0 = torch.rand(cap, R.row_dim(*dims), generator=gen, device=dev)
    ep0 = torch.randn(B, n, generator=gen, device=dev)
    st0 = torch.randn(n + 2, generator=gen, device=dev)
    args = (obs, act, rwd, nobs, done)

    def call(mod, ring, ep, st):
        if with_stats:
            return lambda: mod.replay_insert_tick(ring, ptr, dims, *args,
                                                  reset=reset, ep_ret=ep,
                                                  stats=st)
        return lambda: mod.replay_insert_tick(ring, ptr, dims, *args)
    outs = {}
    for name, mod in (("parent", PKR), ("change", KR), ("rerun", KR)):
        ring, ep, st = ring0.clone(), ep0.clone(), st0.clone()
        call(mod, ring, ep, st)()
        torch.cuda.synchronize()
        outs[name] = (ring, ep, st)
    ring, ep, st = ring0.clone(), ep0.clone(), st0.clone()
    if with_stats:
        KR.replay_insert_tick_plain(ring, ptr, dims, *args, reset, ep, st)
    else:
        KR.replay_insert_tick_plain(ring, ptr, dims, *args)
    c = outs["change"]
    err = float((c[2] - st).abs().max())
    tol = 1e-5 * max(1.0, float(st.abs().max()))
    ok = (same(list(c[:2]), list(outs["parent"][:2]))
          and same(list(c), list(outs["rerun"])) and err <= tol)
    rec = dict(kernel="replay_insert_tick", row_dim=R.row_dim(*dims),
               agents=n, rows=B, cap=cap, ptr=ptr, stats=with_stats,
               ring_and_ep_ret_bitwise_parent=same(list(c[:2]),
                                                  list(outs["parent"][:2])),
               rerun_bitwise=same(list(c), list(outs["rerun"])),
               stats_err_vs_plain=err, stats_tol=tol, ok=ok)
    bufs = {k: (ring0.clone(), ep0.clone(), st0.clone())
            for k in ("parent", "change")}
    return rec, call(PKR, *bufs["parent"]), call(KR, *bufs["change"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="checkout of the earlier commit")
    ap.add_argument("--sizes", default="1,31,32,33,4096")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from actor_spectral_vs_parent import parent_package
    from gym_rotor_tpu_torch.kernels import build
    from gym_rotor_tpu_torch.kernels import env_tick as K
    from gym_rotor_tpu_torch.kernels import replay as KR
    from gym_rotor_tpu_torch.utils.config import Config
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = CS.gpu_name_power()
    parent = parent_package(args.parent)
    PK, PKR = parent("kernels.env_tick"), parent("kernels.replay")
    PConfig = parent("utils.config").Config
    build.build_all([PK.KERNEL, PKR.KERNEL, K.KERNEL, KR.KERNEL])
    sizes = [int(s) for s in args.sizes.split(",")]
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 11)
    bad, slower = [], []
    instances = [(task, integ, exact)
                 for task in ("decoupled", "coupled", "quad")
                 for integ in ("euler", "rk4", "dop853")
                 for exact in (False, True)
                 if task != "quad" or exact]
    for task, integ, exact in instances:
        fw = "MODUL" if task == "decoupled" else "MONO"
        entries = ("tick", "reset", "step") if task != "quad" else ("step",)
        for B in sizes:
            kw = dict(num_envs=B, framework=fw, integrator=integ,
                      exact_so3=exact, train_traj_mode=3 if exact else 0)
            cfg, pcfg = Config(**kw), PConfig(**kw)
            st, a, dr = tick_inputs(K, cfg, B, dev, gen)
            for entry in entries:
                t = None if task != "quad" else "quad"
                fn, get, ft = k1_calls(K, cfg, t, entry, st, a, dr)
                pfn, pget, pft = k1_calls(PK, pcfg, t, entry, st, a, dr)
                fn()
                mine = snapshot(get)
                fn()
                again = snapshot(get)
                pfn()
                theirs = snapshot(pget)
                rec = dict(kernel="env_tick", instance=K.instance(cfg, t),
                           entry=entry, envs=B, mode=cfg.train_traj_mode,
                           bitwise_parent=same(mine, theirs),
                           rerun_bitwise=same(mine, again))
                if entry == "tick":
                    rec["resets"] = int(mine[len(K.empty_bufs(1, dev))
                                             + cfg.n_agents + 2].sum())
                if B in TIMED:
                    rec.update(timed(CS, pft, ft))
                    if rec["slower"]:
                        slower.append(rec)
                print(json.dumps(rec), flush=True)
                if not (rec["bitwise_parent"] and rec["rerun_bitwise"]):
                    bad.append(rec)
    for dims in (((15, 3), (4, 1)), ((23,), (4,))):
        for B in sorted({1, 32, 33, 4096} & set(sizes) | {1, 32, 33}):
            for with_stats in (True, False):
                rec, theirs, mine = replay_case(KR, PKR, dims, B, dev, gen,
                                                with_stats)
                if B in TIMED:
                    rec.update(timed(CS, theirs, mine))
                    if rec["slower"]:
                        slower.append(rec)
                print(json.dumps(rec), flush=True)
                if not rec["ok"]:
                    bad.append(rec)
    print(json.dumps({"disagreeing": bad}), flush=True)
    print(json.dumps({"slower_than_parent": slower}), flush=True)
    print(card, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
