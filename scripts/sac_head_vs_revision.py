"""The fused SAC head, the MLP SAC actor and K2 sample of this tree beside
another tree with the same wrappers (an earlier revision of these kernels),
on one CUDA device.

    python3 scripts/sac_head_vs_revision.py --other DIR

``DIR`` is a checkout of the other revision (``git archive`` into a
git-ignored directory of the repo); its ``gym_rotor_tpu_torch`` is imported
under another name and builds its own kernels.  Both sides get the same
inputs:

- the head (``kernels/sac_sample.py``) at two train-path head shapes and
  three run-time widths (H 8, 40, 64) at 256, 1024 and 1280 rows, in three
  of ``chip_smoke.SAC_HEAD_CASES``: forward and backward (with ``G``)
  outputs compared bitwise;
- the MLP SAC actor at its three instances, at 1, 32 and 4096 rows:
  actions compared bitwise;
- K2 sample at 256 rows in every layout: the operands compared bitwise;

then each timed in turns (other, this tree, this tree, other) with
``chip_smoke.device_ms`` (the backward as the training path launches it);
and this tree's MLP SAC actor at run-time widths (15 / 64 / 4, 15 / 256 /
4, 3 / 50 / 1, 15 / 900 / 4) at 1-4096 rows against its twin.  Prints one
JSON line per case, the empty-kernel floor and the card's name and power
limit.  Exits 1 if any compared output differs.
"""
import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

HEADS = (("o8", 8, 3, False), ("o40", 40, 2, True), ("o64", 64, 2, False))
WIDE_ACTORS = ((15, 64, 4), (15, 256, 4), (3, 50, 1), (15, 900, 4))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="checkout of the other revision")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from actor_spectral_vs_parent import parent_package
    from optim_loss_vs_parent import same, timed
    from gym_rotor_tpu_torch.algos import replay as R
    from gym_rotor_tpu_torch.kernels import build
    from gym_rotor_tpu_torch.kernels import mlp_sac_actor as KM
    from gym_rotor_tpu_torch.kernels import replay as KR
    from gym_rotor_tpu_torch.kernels import sac_sample as K
    from gym_rotor_tpu_torch.models import mlp
    from gym_rotor_tpu_torch.utils.config import Config
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    other = parent_package(args.other)
    OK, OKR, OR, omlp = (other("kernels.sac_sample"), other("kernels.replay"),
                         other("algos.replay"), other("models.mlp"))
    build.build_all([OK.KERNEL, other("kernels.mlp_sac_actor").KERNEL,
                     OKR.KERNEL, K.KERNEL, KM.KERNEL, KR.KERNEL])
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 15)
    bad = []

    def report(rec):
        print(json.dumps(rec), flush=True)
        if rec.get("bitwise") is False:
            bad.append(rec)

    report(dict(floor_ms=CS.device_ms(lambda: torch.cuda._sleep(0), 200)[0]))
    for label, H, act, dense in CS.sac_head_shapes()[:2] + list(HEADS):
        for n in (256, 1024, 1280):
            for case in ("tie", "saturated", "moderate"):   # timed: the last
                h, wm, bm, wl, bl, z, ga, gl = CS.sac_head_inputs(
                    n, H, act, dense, case, gen, dev)
                args_ = (h, wm, bm, wl, bl, z, dense)
                fwd = same(list(K.sac_head(*args_)),
                           list(OK.sac_head(*args_)))
                bwd = same(list(K.sac_head_backward(ga, gl, *args_,
                                                    with_G=True)),
                           list(OK.sac_head_backward(ga, gl, *args_)))
                report(dict(head=label, H=H, act=act, rows=n, case=case,
                            bitwise=fwd and bwd))
            if n == 1280:
                continue
            report(dict(head=label, H=H, act=act, rows=n, forward=timed(
                CS, lambda: OK.sac_head(*args_), lambda: K.sac_head(*args_)),
                backward=timed(
                    CS, lambda: OK.sac_head_backward(ga, gl, *args_),
                    lambda: K.sac_head_backward(ga, gl, *args_))))
    for k, dims in enumerate(((15, 16, 4), (3, 4, 1), (23, 16, 4))):
        nin, nh, nact = dims
        mine = mlp.ActorSAC(nin, nh, nact, device="cpu",
                            generator=torch.Generator().manual_seed(k))
        theirs = omlp.ActorSAC(nin, nh, nact, device="cpu")
        theirs.load_state_dict(mine.state_dict())
        mine, theirs = mine.to(dev), theirs.to(dev)
        for rows in (1, 32, 4096):
            obs = 0.6 * torch.randn(rows, nin, generator=gen, device=dev)
            nz = torch.randn(rows, nact, generator=gen, device=dev)
            with torch.no_grad():
                report(dict(actor=dims, rows=rows,
                            bitwise=same([mine(obs, nz)], [theirs(obs, nz)]),
                            **timed(CS, lambda: theirs(obs, nz),
                                    lambda: mine(obs, nz))))
    for dims in WIDE_ACTORS:
        nin, nh, nact = dims
        mine = mlp.ActorSAC(nin, nh, nact, device="cpu",
                            generator=torch.Generator().manual_seed(9)).to(dev)
        for rows in (1, 10, 32, 1024, 4096):
            obs = 0.6 * torch.randn(rows, nin, generator=gen, device=dev)
            nz = torch.randn(rows, nact, generator=gen, device=dev)
            with torch.no_grad():
                a, a2 = mine(obs, nz), mine(obs, nz)
                ap = KM.mlp_sac_actor_plain(mine, obs, nz)
                report(dict(
                    actor=dims, rows=rows, err_vs_plain=float(
                        (a - ap).abs().max()), rerun_bitwise=same([a], [a2]),
                    ms=CS.device_ms(lambda: mine(obs, nz), 100)[0],
                    plain_ms=CS.device_ms(
                        lambda: KM.mlp_sac_actor_plain(mine, obs, nz),
                        50)[0]))
    cfg = Config()
    dims = (tuple(cfg.obs_dim_n), tuple(cfg.action_dim_n))
    ring = torch.rand(cfg.replay_buffer_size, R.row_dim(*dims), generator=gen,
                      device=dev)
    idx = torch.randint(0, ring.shape[0], (cfg.batch_size,), generator=gen,
                        device=dev)
    nb = idx.shape[0]
    for name, (ctde, stack) in CS.sample_layouts().items():
        lay = R.gather_layout(dims, ctde, stack)
        olay = OR.gather_layout(dims, ctde, stack)
        report(dict(gather=name, rows=nb, bitwise=same(
            lay.written(KR.replay_sample(ring, idx, False, lay), nb),
            olay.written(OKR.replay_sample(ring, idx, False, olay), nb)),
            **timed(CS, lambda: OKR.replay_sample(ring, idx, False, olay),
                    lambda: KR.replay_sample(ring, idx, False, lay))))
    print(json.dumps({"differing": bad}), flush=True)
    print(CS.gpu_name_power(), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
