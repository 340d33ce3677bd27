"""K10 fused with SAC's heads, the fused MLP SAC actor and K2 sample into
the learners' operands, of this tree beside an earlier commit's chains, on
one CUDA device.

    python3 scripts/sac_head_sample_vs_parent.py --parent DIR

``DIR`` is a checkout of the earlier commit (``git archive`` into a
git-ignored directory of the repo).  Its ``gym_rotor_tpu_torch`` package is
imported under another name, so its own wrappers and kernels (built from
``DIR``) serve its side.  Both sides get the same inputs:

- The SAC head at every head shape of the train paths (``chip_smoke``'s
  ``sac_head_shapes``: the EMLP heads of Mod agents 0 and 1 and Mono, the
  MLP heads of Mod-MLP and Mono-MLP) and at the run-time widths of
  ``chip_smoke.SAC_HEAD_OTHER`` (H 8 to 3000) at 256 and 1024 rows: this tree's one
  forward launch and one backward launch held to the plain sample on the
  kernel's own heads (``chip_smoke.sac_head_check``), the earlier commit's
  chain (the heads as torch ops, the clamp, its K10 launch; under autograd
  its K10 backward and torch's backward of the heads) within 1e-5 max(1,
  max |plain|) of the twin forward, and the two sides' gradients within
  1e-3 max(1, max |abs|) of each other.
- The MLP SAC actor (15 / 16 / 4, 3 / 4 / 1, 23 / 16 / 4, and the
  run-time widths 15 / 256 / 4, 3 / 50 / 1 and 15 / 900 / 4) at 1, 10, 32
  and 4096 rows
  with a draw and without (eval): this tree's one launch and
  the earlier commit's chain (``F.linear`` heads, then its K10 forward)
  both within 1e-5 of the twin; reruns bitwise.
- K2 sample at 256 rows of a 1e6-row ring for TD3 and SAC, DTDE and CTDE:
  this tree's one launch into the learners' operands against the earlier
  commit's gather followed by the copies its learners made of the sampled
  fields (``concat(obs, act)`` per critic loss, the CTDE joint fields, the
  CAPS stack's ring blocks): operands and fields bitwise.

Then every case is timed in turns (earlier, this tree, this tree,
earlier) with ``chip_smoke.device_ms``, its kernels' traced device time
taken with ``chip_smoke.kernel_ms``, and the CUDA kernels one call
launches are counted from a ``torch.profiler`` trace on both sides; last,
the kernels one TD3 and one SAC update launch (the sample and
``train_step``, DTDE and CTDE, EMLP and MLP networks), counted the same
way on both sides.  Prints one JSON line per check and per timing, the
cases where this tree is slower beyond the spread of the two turns, and
the card's name and power limit.  Exits 1 if any output disagrees or a
forward or backward call of this tree's head or acting kernel launches
other than one kernel.
"""
import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

HEAD_ROWS = (256, 1024)
# the instances, then run-time widths (the actors of actor_hidden_dim
# (256, 50), and a far wider one)
ACTOR_SHAPES = ((15, 16, 4), (3, 4, 1), (23, 16, 4), (15, 256, 4), (3, 50, 1),
                (15, 900, 4))
ACTOR_ROWS = (1, 10, 32, 4096)
UPDATES = (("td3", {}), ("td3_ctde", dict(module_training="CTDE")),
           ("td3_mlp", dict(use_equiv=False)), ("sac", dict(rl_algo="SAC")),
           ("sac_ctde", dict(rl_algo="SAC", module_training="CTDE")),
           ("sac_mlp", dict(rl_algo="SAC", use_equiv=False)))


def rel_err(a, b):
    return float((a.double() - b.double()).abs().max()) / max(
        1.0, float(b.abs().max()))


def head_case(CS, K, PK, label, H, act, dense, n, dev, gen):
    """One head shape at ``n`` rows: checks, then (forward, backward)
    closures of both sides."""
    h, wm, bm, wl, bl, z, g_a, g_l = CS.sac_head_inputs(
        n, H, act, dense, "moderate", gen, dev)
    checks, same, _ = CS.sac_head_check(h, wm, bm, wl, bl, z, g_a, g_l,
                                        dense)
    ap, lp = K.sac_head_plain(h, wm, bm, wl, bl, z, dense)
    with torch.no_grad():
        a_par, l_par = PK.sac_sample(*K.head_plain(h, wm, bm, wl, bl, dense),
                                     z)
    mine_leaves = [t.clone().requires_grad_(True) for t in (h, wm, bm, wl, bl)]
    par_leaves = [t.clone().requires_grad_(True) for t in (h, wm, bm, wl, bl)]
    am, lm = K.sac_head_sample(*mine_leaves, z, dense)
    apg, lpg = PK.squashed_gaussian(*K.head_plain(*par_leaves, dense), z)

    def bwd_mine():
        return torch.autograd.grad((am, lm), mine_leaves, (g_a, g_l),
                                   retain_graph=True)

    def bwd_par():
        return torch.autograd.grad((apg, lpg), par_leaves, (g_a, g_l),
                                   retain_graph=True)
    grads = [rel_err(x, y) for x, y in zip(bwd_mine(), bwd_par())]
    parent_fwd = max(rel_err(a_par, ap), rel_err(l_par, lp))
    rec = dict(kernel="sac_head", head=label, H=H, act=act, dense=dense,
               rows=n, rerun_bitwise=same,
               worst_tolerance_ratio={k: v[1] for k, v in checks.items()},
               parent_fwd_rel_err_vs_twin=parent_fwd,
               grads_rel_err_vs_parent=grads)
    rec["ok"] = (same and all(v[1] <= 1.0 and v[2] for v in checks.values())
                 and parent_fwd <= 1e-5 and max(grads) <= 1e-3)

    def fwd_mine():
        K.sac_head(h, wm, bm, wl, bl, z, dense)

    def fwd_par():
        PK.sac_sample(*K.head_plain(h, wm, bm, wl, bl, dense), z)

    # the backward launch alone, as the training path makes it and with
    # G = [g_mean | g_log_std] written out (the checks' launch)
    rec["backward_launch_ms"] = CS.device_ms(lambda: K.sac_head_backward(
        g_a, g_l, h, wm, bm, wl, bl, z, dense), 200)[0]
    rec["backward_launch_with_G_ms"] = CS.device_ms(
        lambda: K.sac_head_backward(g_a, g_l, h, wm, bm, wl, bl, z, dense,
                                    with_G=True), 200)[0]
    return rec, (fwd_par, fwd_mine), (bwd_par, bwd_mine)


def actor_case(KM, mine, theirs, dims, rows, noisy, dev, gen):
    from optim_loss_vs_parent import same
    nin, _, nact = dims
    obs = 0.6 * torch.randn(rows, nin, generator=gen, device=dev)
    noise = (torch.randn(rows, nact, generator=gen, device=dev) if noisy
             else None)
    with torch.no_grad():
        ak, ak2 = mine(obs, noise), mine(obs, noise)
        ap_ = theirs(obs, noise)
        ap = KM.mlp_sac_actor_plain(mine, obs, noise)
    torch.cuda.synchronize()
    errs = dict(action=float((ak - ap).abs().max()),
                parent_action=float((ap_ - ap).abs().max()))
    rec = dict(kernel="mlp_sac_actor", dims=list(dims), rows=rows,
               mode="train" if noisy else "eval", err_vs_plain=errs, tol=1e-5,
               rerun_bitwise=same([ak], [ak2]))
    rec["ok"] = (rec["rerun_bitwise"] and errs["action"] <= 1e-5
                 and errs["parent_action"] <= 1e-5
                 and bool(torch.isfinite(ak).all()))
    out = torch.empty(rows, nact, device=dev)

    def call_mine():
        mine(obs, noise, out)

    def call_theirs():
        theirs(obs, noise, out)
    return rec, call_theirs, call_mine


def actor_pair(mlp, pmlp, dims, dev, seed):
    nin, nh, nact = dims
    gen = torch.Generator().manual_seed(seed)
    mine = mlp.ActorSAC(nin, nh, nact, device="cpu", generator=gen)
    theirs = pmlp.ActorSAC(nin, nh, nact, device="cpu")
    theirs.load_state_dict(mine.state_dict())
    return mine.to(dev), theirs.to(dev)


def gather_case(CS, R, PR, name, ctde, stack, dims, ring, idx, eps):
    """This tree's sample into the operands vs the earlier commit's sample
    and the copies its learners made (every agent's)."""
    from optim_loss_vs_parent import same
    n = len(dims[0])
    nb = idx.shape[0]
    rs = R.ReplayState(data=ring, ptr=0, filled=ring.shape[0], dims=dims)
    prs = PR.ReplayState(data=ring, ptr=0, filled=ring.shape[0], dims=dims)

    def parent_ops(b):
        """The earlier learners' copies of the sampled fields."""
        out = []
        if ctde:
            out += [torch.cat(list(b.obs) + list(b.act), dim=-1),
                    torch.cat(b.next_obs, dim=-1)]
        for i in range(n):
            if not ctde:
                out.append(torch.cat([b.obs[i], b.act[i]], dim=-1))
            blocks = [b.obs[i] if f == "obs" else b.next_obs[i]
                      for f in stack if f != "eps"]
            out.append(torch.cat(blocks + [b.obs[i] + eps[i]], dim=0))
        return out

    def mine():
        return R.sample(rs, nb, idx=idx, ctde=ctde, stack=stack)

    def theirs():
        b = PR.sample(prs, nb, idx=idx)
        return b, parent_ops(b)
    b, pb = mine(), theirs()
    mine_ops = []
    if ctde:
        mine_ops += [b.ops.sa[0], b.ops.t_obs]
    for i in range(n):
        if not ctde:
            mine_ops.append(b.ops.sa[i])
        stk = b.ops.stack[i]
        torch.add(b.obs[i], eps[i], out=stk[-nb:])
        mine_ops.append(stk)
    fields = same([t for f in b[:5] for t in f],
                  [t.contiguous() for f in pb[0] for t in f])
    ops = same([t.contiguous() for t in mine_ops],
               [t.contiguous() for t in pb[1]])
    rec = dict(kernel="replay_sample", layout=name, rows=nb,
               fields_bitwise=fields, operands_bitwise=ops)
    rec["ok"] = fields and ops
    return rec, (lambda: PR.sample(prs, nb, idx=idx)), mine, \
        (lambda: parent_ops(PR.sample(prs, nb, idx=idx)))


def update_launches(CS, side, name, kw, dev):
    """CUDA kernels of one update (the sample and ``train_step``) on one
    side's package, averaged over a multiple of the delayed actor's
    period."""
    Config = side("utils.config").Config
    R, D = side("algos.replay"), side("envs.draws")
    cfg = Config(num_envs=4096, **kw)
    sac = cfg.rl_algo == "SAC"
    learner = side("algos.sac" if sac else "algos.td3")
    Agent = learner.SACAgent if sac else learner.TD3Agent
    agents = [Agent(cfg, i, dev) for i in range(cfg.n_agents)]
    gen = torch.Generator().manual_seed(0)
    states = [a.init(gen) for a in agents]
    rs = R.create(cfg.replay_buffer_size, cfg.obs_dim_n, cfg.action_dim_n,
                  device=dev)
    rs.data.uniform_(-1.0, 1.0)
    rs.filled = rs.data.shape[0]
    draws_fn = D.make_sac_update_draws if sac else D.make_update_draws
    kwargs = {}
    if hasattr(learner, "caps_stack"):
        kwargs = dict(ctde=cfg.is_ctde, stack=learner.caps_stack(cfg.is_ctde))
    elif hasattr(learner, "CAPS_STACK"):
        kwargs = dict(ctde=cfg.is_ctde, stack=learner.CAPS_STACK)
    dgen = torch.Generator(device=dev).manual_seed(1)

    def update():
        ud = draws_fn(cfg.batch_size, rs.filled, cfg.obs_dim_n,
                      cfg.action_dim_n, [a.critic_widths for a in agents],
                      [a.actor_widths for a in agents], dgen, dev,
                      ctde=cfg.is_ctde)
        batch = R.sample(rs, cfg.batch_size, idx=ud.idx, **kwargs)
        learner.train_step(cfg, agents, states, batch, ud.agents)
    period = 1 if sac else cfg.policy_update_freq
    return CS.launches_per_call(update, n=4 * period)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="checkout of the earlier commit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import importlib
    import chip_smoke as CS
    from actor_spectral_vs_parent import parent_package
    from optim_loss_vs_parent import clocks, timed
    from gym_rotor_tpu_torch.algos import replay as R
    from gym_rotor_tpu_torch.kernels import build
    from gym_rotor_tpu_torch.kernels import mlp_sac_actor as KM
    from gym_rotor_tpu_torch.kernels import replay as KR
    from gym_rotor_tpu_torch.kernels import sac_sample as K
    from gym_rotor_tpu_torch.models import mlp
    from gym_rotor_tpu_torch.utils.config import Config
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = CS.gpu_name_power()
    parent = parent_package(args.parent)
    PK, PR, pmlp = (parent("kernels.sac_sample"), parent("algos.replay"),
                    parent("models.mlp"))
    mods = ("env_tick", "emlp_actor", "replay", "emlp_block", "flat_adamw",
            "spectral", "sac_sample")
    build.build_all([parent(f"kernels.{m}").KERNEL for m in mods]
                    + [m.KERNEL for m in CS._kernel_modules()])
    for src in (K.KERNEL, KM.KERNEL, KR.KERNEL):
        print(json.dumps(dict(build=src.name, seconds=src.build_seconds,
                              ptxas=src.resources())), flush=True)
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 14)
    bad, slower = [], []
    clocks()

    def report(rec):
        print(json.dumps(rec), flush=True)
        if not rec["ok"]:
            bad.append(rec)
        if rec.get("slower"):
            slower.append(rec)

    for label, H, act, dense in (CS.sac_head_shapes()
                                 + list(CS.SAC_HEAD_OTHER)):
        for n in HEAD_ROWS:
            rec, fwd, bwd = head_case(CS, K, PK, label, H, act, dense, n,
                                      dev, gen)
            with torch.no_grad():
                rec["forward"] = timed(CS, *fwd)
                rec["forward"]["kernels_a_call"] = CS.launches_per_call(fwd[1])
                rec["forward"]["parent_kernels_a_call"] = \
                    CS.launches_per_call(fwd[0])
            rec["backward"] = timed(CS, *bwd, n=100)
            rec["backward"]["kernels_a_call"] = CS.launches_per_call(bwd[1])
            rec["backward"]["parent_kernels_a_call"] = \
                CS.launches_per_call(bwd[0])
            rec["slower"] = rec["forward"]["slower"] or rec["backward"]["slower"]
            if rec["forward"]["kernels_a_call"] != 1:
                rec["ok"] = False
            report(rec)

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
                report(rec)

    layouts = CS.sample_layouts()
    for fw in ("MODUL", "MONO"):
        cfg = Config(framework=fw)
        dims = (tuple(cfg.obs_dim_n), tuple(cfg.action_dim_n))
        ring = torch.rand(cfg.replay_buffer_size, R.row_dim(*dims),
                          generator=gen, device=dev)
        idx = torch.randint(0, ring.shape[0], (cfg.batch_size,),
                            generator=gen, device=dev)
        eps = [0.05 * torch.randn(1, d, generator=gen, device=dev)
               for d in dims[0]]
        for name in ("td3", "td3_ctde", "sac", "sac_ctde"):
            ctde, stack = layouts[name]
            if ctde and fw == "MONO":
                continue
            rec, p_sample, m_sample, p_ops = gather_case(
                CS, R, PR, name, ctde, stack, dims, ring, idx, eps)
            rec["framework"] = fw
            rec["sample"] = timed(CS, p_sample, m_sample)
            rec["sample_and_copies"] = timed(CS, p_ops, m_sample)
            rec["kernels_a_call"] = CS.launches_per_call(m_sample)
            rec["parent_kernels_a_call"] = CS.launches_per_call(p_ops)
            rec["slower"] = rec["sample_and_copies"]["slower"]
            if rec["kernels_a_call"] != 1:
                rec["ok"] = False
            report(rec)

    mine_pkg = lambda name: importlib.import_module(  # noqa: E731
        f"gym_rotor_tpu_torch.{name}")
    for name, kw in UPDATES:
        rec = dict(update=name,
                   parent_kernels_a_call=update_launches(CS, parent, name, kw,
                                                         dev),
                   kernels_a_call=update_launches(CS, mine_pkg, name, kw,
                                                  dev), ok=True)
        report(rec)
    clocks()
    print(json.dumps({"disagreeing": bad}), flush=True)
    print(json.dumps({"slower_than_parent": slower}), flush=True)
    print(card, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
