"""Drive the PyTorch port's acting path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own line; any failure exits non-zero and prints no
result line):
  1. build      nvcc both kernels in parallel; print build time and the
                registers/spills ``-Xptxas -v`` reports
  2. env_tick   K1 kernel vs its plain twin at B = 4096 float32 train envs:
                batched reset, 50 plain ticks, ~10% of envs one tick from
                the cap, then one kernel tick and one plain tick on the same
                state, actions and draws (and the reset entry vs plain);
                the same at the eval path's 10 eval envs
  3. emlp_actor K3 kernel vs the structured plain actor, both agents,
                B = 4096 and the eval path's B = 10, seeded weights
  4. rollout    4096 train envs x 1000 ticks, both actors through K3 and the
                tick through K1; launch counts read from the wrappers;
                SO(3) and reward-range invariants; env-steps/s by CUDA events
  5. eval       ``evaluate``: 10 eval envs x 1000 ticks; launch counts
                read from the wrappers (one reset, then K1 once and K3
                twice per tick)
  6. kernels    per kernel: launches on the rollout, device time per launch,
                plain twin's time, the H100 bound (K3's operations counted
                from the nonzeros of its bilinear form)
Then the card's name and power limit, one JSON line of kernel records, and
last the ``{"ok": true, "device": ...}`` line.

Imports nothing of JAX or of the JAX package.
"""
import json
import math
import statistics
import subprocess
import sys
import time
import traceback

import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
B = 4096
TICKS = 1000
SEED = 0
CARD = ""            # nvidia-smi name and power limit, set in main()


def log(phase, **kv):
    if phase in ("rollout", "eval", "kernels"):
        kv["card"] = CARD
    print(f"[{phase}] " + json.dumps(kv, sort_keys=False), flush=True)


def gpu_name_power():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi failed: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------
_CYCLES_PER_MS = None


def _cycles_per_ms():
    global _CYCLES_PER_MS
    if _CYCLES_PER_MS is None:
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        torch.cuda._sleep(20_000_000)
        e.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS = 20_000_000 / s.elapsed_time(e)
    return _CYCLES_PER_MS


def device_ms(fn, n, rounds=5):
    """Device time per call, back to back: the stream is kept busy by a spin
    kernel while the host enqueues ``n`` calls, then CUDA events bracket the
    calls; median over ``rounds``.  Also returns the host wall time per call
    (launch overhead included, synchronised)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    dev = []
    for _ in range(rounds):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(_cycles_per_ms() * wall * 1e3 * n * 2.0) + 100_000)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        dev.append(s.elapsed_time(e) / n)
    return statistics.median(dev), wall * 1e3


def bound_ms(nbytes, flops):
    tb = nbytes / H100_BYTES_PER_S * 1e3
    tf = flops / H100_FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# Floating-point operations of the plain twins, counted from the code
# ---------------------------------------------------------------------------
_FLOP_FUNCS = {"add": 1, "sub": 1, "mul": 1, "div": 1, "neg": 1, "sqrt": 1,
               "sin": 1, "cos": 1, "atan2": 1, "abs": 1, "maximum": 1,
               "minimum": 1, "clamp": 2, "sigmoid": 3, "tanh": 1, "exp": 1,
               "__add__": 1, "__radd__": 1, "__sub__": 1, "__rsub__": 1,
               "__mul__": 1, "__rmul__": 1, "__truediv__": 1,
               "__rtruediv__": 1, "__rdiv__": 1, "__neg__": 1, "__abs__": 1}


def count_flops(fn, *args):
    """Elementwise floating-point operations ``fn`` performs, counted per
    output element (a transcendental counts as one), on the CPU."""
    from torch.overrides import TorchFunctionMode

    class Counter(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            w = _FLOP_FUNCS.get(getattr(func, "__name__", ""), 0)
            if w and isinstance(out, torch.Tensor) and out.is_floating_point():
                Counter.n += w * out.numel()
            return out

    with Counter():
        fn(*args)
    return Counter.n


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------
def phase_build():
    from gym_rotor_tpu_torch.kernels import build, emlp_actor, env_tick
    srcs = [env_tick.KERNEL, emlp_actor.KERNEL]
    t0 = time.perf_counter()
    build.build_all(srcs)
    wall = time.perf_counter() - t0
    for s in srcs:
        log("build", kernel=s.name, nvcc_s=s.build_seconds,
            ptxas=s.resources())
    log("build", parallel_wall_s=wall)


def _field_errors(named_k, named_p, skip):
    """Per field max abs / rel difference over envs not in ``skip``;
    continuous fields must satisfy |k - p| <= 1e-6 + 1e-5 |p|."""
    errs, bad, worst = {}, [], 0.0
    keep = ~skip
    for path, p in named_p.items():
        k = named_k[path]
        kk, pp = k[keep], p[keep]
        if p.is_floating_point():
            d = (kk.double() - pp.double()).abs()
            rel = d / pp.double().abs().clamp_min(1e-30)
            a, r = float(d.max()) if d.numel() else 0.0, float(rel.max()) if d.numel() else 0.0
            errs[path] = [a, r]
            worst = max(worst, a)
            if d.numel() and bool((d > 1e-6 + 1e-5 * pp.double().abs()).any()):
                bad.append(path)
        else:
            n = int((kk != pp).sum())
            errs[path] = n
            if n:
                bad.append(path)
    return errs, bad, worst


def _near_threshold(out):
    """Envs whose deciding value lies within 1e-5 of a threshold: crash
    limits |obs| >= 1 and the solved tolerances |ex|, |eb1| <= 0.03."""
    o1, o2 = out.info["terminal_obs"]
    crash = torch.cat([o1[:, 0:3], o1[:, 6:9], o1[:, 12:15], o2[:, 2:3]], 1)
    near = ((crash.abs() - 1.0).abs() < 1e-5).any(1)
    near |= ((out.info["ex"].abs() - 0.03).abs() < 1e-5).any(1)
    near |= (out.info["eb1"].abs() - 0.03).abs() < 1e-5
    return near


def _named(state, out=None):
    from gym_rotor_tpu_torch.utils.tree import tree_named_leaves
    d = {f"state.{p}": t for p, t in tree_named_leaves(state)}
    if out is not None:
        d.update({"obs1": out.obs[0], "obs2": out.obs[1], "reward": out.reward,
                  "done": out.done, "reset_happened": out.reset_happened,
                  "info.ex": out.info["ex"], "info.eb1": out.info["eb1"],
                  "info.terminal_obs1": out.info["terminal_obs"][0],
                  "info.terminal_obs2": out.info["terminal_obs"][1],
                  "info.crashed": out.info["crashed"]})
    return d


def phase_env_tick(cfg, dev, n, env_type):
    """K1 (reset entry and tick) vs the plain twin on ``n`` envs."""
    from gym_rotor_tpu_torch.envs import draws as D
    from gym_rotor_tpu_torch.envs.batch import batched_reset_plain
    from gym_rotor_tpu_torch.kernels import env_tick as K
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def actions():
        a = 0.35 * torch.randn(n, 5, generator=gen, device=dev)
        a[:, 0] = torch.rand(n, generator=gen, device=dev) * 0.5 - 0.4
        return a

    def uniforms():
        return D.draw_uniforms(n, gen, torch.float32, dev)

    draws = uniforms()
    st_k, obs_k = K.env_reset(cfg, draws, env_type)
    st_p, obs_p = batched_reset_plain(cfg, draws, env_type)
    nk = _named(st_k)
    nk.update({"obs1": obs_k[0], "obs2": obs_k[1]})
    np_ = _named(st_p)
    np_.update({"obs1": obs_p[0], "obs2": obs_p[1]})
    errs, bad, worst_reset = _field_errors(
        nk, np_, torch.zeros(n, dtype=torch.bool, device=dev))
    log("env_tick", check="reset kernel vs plain", envs=n, env_type=env_type,
        max_abs_err=worst_reset, fields=errs)
    if bad:
        raise AssertionError(f"env reset kernel disagrees with plain: {bad}")

    st = st_p
    for _ in range(50):
        st, _ = K.env_tick_plain(cfg, st, actions(), uniforms(), env_type)
    idx = torch.randperm(n, generator=gen, device=dev)[: max(1, n // 10)]
    st.env.t[idx] = cfg.max_steps - 1
    a, dr = actions(), uniforms()
    st_k, out_k = K.env_tick(cfg, st, a, dr, env_type)
    st_p, out_p = K.env_tick_plain(cfg, st, a, dr, env_type)
    nk, np_ = _named(st_k, out_k), _named(st_p, out_p)
    near = _near_threshold(out_p) | _near_threshold(out_k)
    mismatch = torch.zeros(n, dtype=torch.bool, device=dev)
    for path, p in np_.items():
        if not p.is_floating_point():
            diff = nk[path] != p
            mismatch |= diff.reshape(n, -1).any(1)
    unexplained = int((mismatch & ~near).sum())
    errs, bad, worst = _field_errors(nk, np_, mismatch)
    n_reset = int(out_p.reset_happened.sum())
    log("env_tick", check="tick kernel vs plain", envs=n, env_type=env_type,
        resets=n_reset, caps_set=int(idx.numel()),
        near_threshold_envs=int(near.sum()),
        discrete_mismatch_envs=int(mismatch.sum()),
        unexplained_mismatch_envs=unexplained, max_abs_err=worst, fields=errs)
    if unexplained or bad:
        raise AssertionError(f"env_tick kernel disagrees with plain: "
                             f"{unexplained} envs, fields {bad}")
    return dict(state=st, actions=a, draws=dr, n_reset=n_reset,
                max_abs_err=max(worst, worst_reset))


def phase_emlp(cfg, dev, obs):
    from gym_rotor_tpu_torch.kernels import emlp_actor as K
    from gym_rotor_tpu_torch.models.emlp.zoo import make_actors
    actors = make_actors(cfg, device=dev, seed=SEED)
    worst = 0.0
    for i, (actor, o_full) in enumerate(zip(actors, obs)):
        # the rollout's batch and the eval path's (one partial block)
        for o in (o_full, o_full[:cfg.num_eval]):
            with torch.no_grad():
                yk = K.emlp_actor(actor, o)
                yp = K.emlp_actor_plain(actor, o)
            err = float((yk - yp).abs().max())
            worst = max(worst, err)
            log("emlp_actor", agent=i, batch=int(o.shape[0]),
                dims=K.actor_dims(actor), max_abs_err=err,
                finite=bool(torch.isfinite(yk).all()))
            if not err <= 1e-5 or not torch.isfinite(yk).all():
                raise AssertionError(f"emlp_actor agent {i}: max abs err {err}")
    return actors, worst


def phase_rollout(cfg, dev, actors):
    from gym_rotor_tpu_torch.envs.batch import batched_reset, rollout
    from gym_rotor_tpu_torch.evaluate import joint_policy
    from gym_rotor_tpu_torch.kernels.emlp_actor import emlp_actor
    from gym_rotor_tpu_torch.kernels.env_tick import env_tick
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bs, obs = batched_reset(cfg, gen, device=dev)
    policy = joint_policy(actors)
    torch.cuda.synchronize()
    env_tick.launches = 0
    emlp_actor.launches = 0
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    bs, obs, trs, outs = rollout(cfg, bs, obs, policy, TICKS, gen)
    e.record()
    torch.cuda.synchronize()
    launches = {"env_tick": env_tick.launches, "emlp_actor": emlp_actor.launches}
    ms = s.elapsed_time(e)
    R = bs.env.R
    ortho = float((R.transpose(-1, -2) @ R - torch.eye(3, device=dev)).abs().max())
    r = outs.reward
    r_ok = bool((((r >= 0) & (r <= 1)) | (r == -1)).all())
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (r, outs.obs[0], outs.obs[1], bs.env.x, bs.env.R))
    log("rollout", envs=B, ticks=TICKS, launches=launches,
        env_steps_per_s=B * TICKS / (ms / 1e3), rollout_ms=ms,
        max_RtR_minus_I=ortho, rewards_in_range=r_ok, finite=finite,
        episodes_ended=int(outs.reset_happened.sum()),
        mean_reward=[float(x) for x in r.clamp_min(0).mean((0, 1))])
    if launches != {"env_tick": TICKS, "emlp_actor": 2 * TICKS}:
        raise AssertionError(f"launch counts {launches}")
    if not (ortho < 1e-5 and r_ok and finite):
        raise AssertionError("rollout invariants failed")
    return launches


def phase_eval(cfg, dev, actors):
    from gym_rotor_tpu_torch.envs.quad import DT
    from gym_rotor_tpu_torch.evaluate import evaluate
    from gym_rotor_tpu_torch.kernels.emlp_actor import emlp_actor
    from gym_rotor_tpu_torch.kernels.env_tick import env_tick
    ticks = int(round(cfg.eval_max_steps / DT))
    torch.cuda.synchronize()
    env_tick.launches = 0
    emlp_actor.launches = 0
    t0 = time.perf_counter()
    ep, bench, succ, ex, eb1 = evaluate(cfg, actors, device=dev)
    torch.cuda.synchronize()
    launches = {"env_tick": env_tick.launches, "emlp_actor": emlp_actor.launches}
    vals = [float(x) for x in ep] + [float(bench)]
    log("eval", envs=cfg.num_eval, ticks=ticks, launches=launches,
        mean_episode_reward=vals[:2], benchmark_reward=vals[2],
        success=[int(x) for x in succ.sum(0)], wall_s=time.perf_counter() - t0)
    # one reset launch, then one K1 and one K3 per agent each tick
    if launches != {"env_tick": 1 + ticks, "emlp_actor": 2 * ticks}:
        raise AssertionError(f"eval launch counts {launches}")
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError("eval produced non-finite rewards")


def phase_kernels(cfg, dev, tick, actors, obs, launches, emlp_err):
    from gym_rotor_tpu_torch.envs import batch as batch_lib
    from gym_rotor_tpu_torch.envs import draws as D
    from gym_rotor_tpu_torch.kernels import emlp_actor as KA
    from gym_rotor_tpu_torch.kernels import env_tick as KT
    records = []

    # K1 at B = 4096 on the compare-phase state (~10% of envs reset)
    st, a, dr = tick["state"], tick["actions"], tick["draws"]
    in_bufs, out_bufs = KT.pack_state(st), KT.empty_bufs(B, dev)
    k_ms, k_wall = device_ms(
        lambda: KT.env_tick_bufs(cfg, in_bufs, a, dr, "train", out_bufs), 50)
    p_ms, p_wall = device_ms(lambda: KT.env_tick_plain(cfg, st, a, dr), 5, 3)
    nbytes = sum(t.numel() * t.element_size() for t in in_bufs) * 2
    nbytes += a.numel() * 4 + dr.numel() * 4
    nbytes += B * (sum(w for _, w in KT.OUT_FLOAT) * 4 + sum(w for _, w in KT.OUT_BOOL))
    cpu_cfg = cfg.replace(num_envs=1)
    st1, _ = batch_lib.batched_reset_plain(cpu_cfg, torch.rand(1, D.N_DRAWS))
    a1, d1 = torch.zeros(1, 5), torch.rand(1, D.N_DRAWS)
    dense = count_flops(batch_lib.batched_step_plain, cpu_cfg, st1, a1, d1)
    fresh = count_flops(batch_lib._fresh, cpu_cfg, d1, "train")
    flops = B * (dense - fresh) + tick["n_reset"] * fresh
    bms, by = bound_ms(nbytes, flops)
    records.append(dict(
        name="env_tick", route="cuda",
        source="gym_rotor_tpu_torch/kernels/csrc/env_tick.cu",
        replaces="gym_rotor_tpu/envs/batch.py:75", launches=launches["env_tick"],
        max_abs_err=tick["max_abs_err"], ms=k_ms, plain_ms=p_ms, bound_ms=bms,
        bound_by=by, library_ms=None))
    log("kernels", kernel="env_tick", batch=B, resets_in_timed_tick=tick["n_reset"],
        ms=k_ms, wall_ms_per_call=k_wall, plain_ms=p_ms, plain_wall_ms=p_wall,
        bytes=nbytes, flops_step_per_env=dense - fresh, flops_fresh_per_env=fresh,
        flops=flops, bound_ms=bms, bound_by=by, library_ms=None)

    # K3 at B = 4096, both agents (each launched once per tick)
    per = []
    for i, (actor, o) in enumerate(zip(actors, obs)):
        with torch.no_grad():
            k_ms, k_wall = device_ms(lambda: KA.emlp_actor(actor, o), 100)
            p_ms, p_wall = device_ms(lambda: KA.emlp_actor_plain(actor, o), 10, 3)
        folded = KA.fold_actor(actor)
        nin, ng, nh, nact = folded["dims"]
        # per row: each block's linear layer (multiply-add + bias), three
        # flops per nonzero of its quadratic form, 0.1 * q + lin, the gate
        # (negate, exp, add, divide); then the head and its tanh
        per_row = sum(2 * ng * ni + ng + 3 * nnz + 2 * ng + 4 * nh
                      for ni, nnz in zip((nin, nh), folded["nnz"]))
        per_row += 2 * nh * nact + 2 * nact
        flops = B * per_row
        nbytes = (o.numel() + B * nact + folded["params"].numel()
                  + folded["ints"].numel()) * 4
        bms, by = bound_ms(nbytes, flops)
        per.append((k_ms, p_ms, bms, by))
        log("kernels", kernel="emlp_actor", agent=i, dims=[nin, ng, nh, nact],
            bilinear_nonzeros=list(folded["nnz"]), batch=B, ms=k_ms,
            wall_ms_per_call=k_wall, plain_ms=p_ms, plain_wall_ms=p_wall,
            bytes=nbytes, flops=flops, bound_ms=bms, bound_by=by,
            library_ms=None)
    # one record per kernel: the two instances are launched equally often,
    # so per-launch times are their mean
    records.append(dict(
        name="emlp_actor", route="cuda",
        source="gym_rotor_tpu_torch/kernels/csrc/emlp_actor.cu",
        replaces="gym_rotor_tpu/models/emlp/nn.py:431",
        launches=launches["emlp_actor"], max_abs_err=emlp_err,
        ms=statistics.mean(p[0] for p in per),
        plain_ms=statistics.mean(p[1] for p in per),
        bound_ms=statistics.mean(p[2] for p in per),
        bound_by="operations" if all(p[3] == "operations" for p in per) else per[0][3],
        library_ms=None))
    return records


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2
    try:
        from gym_rotor_tpu_torch.utils.config import Config
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    global CARD
    card = CARD = gpu_name_power()
    log("device", name=torch.cuda.get_device_name(0), nvidia_smi=card,
        torch=torch.__version__, cuda=torch.version.cuda)
    cfg = Config(num_envs=B)        # flagship: MODUL, TD3, EMLP, rk4, 4096 envs

    phase_build()
    tick = phase_env_tick(cfg, dev, B, "train")
    # the eval path's shape: one partial block, nominal params
    small = phase_env_tick(cfg.replace(num_envs=cfg.num_eval), dev,
                           cfg.num_eval, "eval")
    tick["max_abs_err"] = max(tick["max_abs_err"], small["max_abs_err"])
    from gym_rotor_tpu_torch.kernels import env_tick as KT
    # realistic actor inputs: the obs of the compare-phase tick
    _, out = KT.env_tick(cfg, tick["state"], tick["actions"], tick["draws"])
    obs = tuple(o.contiguous() for o in out.obs)
    actors, emlp_err = phase_emlp(cfg, dev, obs)
    launches = phase_rollout(cfg, dev, actors)
    phase_eval(cfg, dev, actors)
    records = phase_kernels(cfg, dev, tick, actors, obs, launches, emlp_err)
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:           # any phase failure: report and exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
