"""The acting kernel (K3-actor, K9, K11: ``csrc/emlp_actor.cu``) on the CPU:
the host's plan of each block's bilinear form and the image the kernel
copies to shared memory, for the three instances the learners launch; the
fold cache that carries them; and a torch emulation of the kernel's order
of summation (a 32-row tile on a warp's lanes; each warp four linear
outputs, in input order, then the bias; each warp the bilinear outputs its
plan gives it, each output's nonzeros in order; the gate; the head a warp
an action) against the plain twins and against the flax actors under
JAX's own draws.  The CUDA kernel itself is held to the twins by
``chip_smoke.py`` on the card.

Tolerances.  The emulation in float64 against the twins in float64:
1e-12 of the largest entry (the same sums in another order).  In float32
against the twins in float32 and against the flax actors in float64 with
the same float32 weights: actions 1e-5, log-probs 2e-5 max(1, max |ref|),
the kernel's own tolerances against its twin in ``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gym_rotor_tpu.algos import ppo as jppo
from gym_rotor_tpu.algos import sac as jsac
from gym_rotor_tpu.models.emlp import zoo as jzoo
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch import convert
from gym_rotor_tpu_torch.kernels import emlp_actor as K
from gym_rotor_tpu_torch.models.emlp.nn import bilinear_index
from gym_rotor_tpu_torch.models.emlp import zoo as tzoo
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from torch_jax_fixtures import jax_rho_memo  # noqa: F401

torch.set_num_threads(1)
# (framework, agent) of each instance (nin, ng, nh, nact)
INSTANCES = {(15, 18, 16, 4): ("MODUL", 0), (3, 7, 4, 1): ("MODUL", 1),
             (23, 18, 16, 4): ("MONO", 0)}
HEADS = {K.HEAD_TANH: "tanh", K.HEAD_GAUSS: "gauss", K.HEAD_PPO: "ppo"}
ROWS = (1, 10, 31, 32, 33, 256)
CLASSES = {K.HEAD_TANH: "EMLPActorDet", K.HEAD_GAUSS: "EMLPActorSAC",
           K.HEAD_PPO: "EMLPActorPPO"}


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, ref, rel, what="", floor=0.0):
    """|got - ref| <= rel * max(max |ref|, floor), elementwise."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref), initial=0.0)), floor, 1e-30)
    err = float(np.max(np.abs(got - ref), initial=0.0))
    assert err <= rel * scale, f"{what}: err {err:.3e} vs scale {scale:.3e}"


def _make(head, cfg, fw, agent, **kw):
    """A port actor of ``head``'s class (the SAC and PPO ones take the
    action width) on the CPU."""
    reps = tzoo.actor_reps(cfg, fw, agent)
    if head == K.HEAD_TANH:
        return tzoo.EMLPActorDet(*reps, device="cpu", **kw)
    return getattr(tzoo, CLASSES[head])(*reps, cfg.action_dim_n[agent],
                                        device="cpu", **kw)


def _actor(dims, head, dtype=torch.float32, seed=0):
    """A port actor of ``dims`` with ``head``'s class, seeded weights (the
    PPO actor's ``log_std`` moved off 0, so the draws clip)."""
    fw, agent = INSTANCES[dims]
    cfg = TConfig(framework=fw)
    actor = _make(head, cfg, fw, agent, dtype=dtype,
                  generator=torch.Generator().manual_seed(seed))
    if head == K.HEAD_PPO:
        with torch.no_grad():
            actor.log_std.copy_(torch.linspace(-0.6, 0.5, dims[3]))
        actor.bump_version()
    return actor


# ---------------------------------------------------------------------------
# The plan and the image
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dims", sorted(INSTANCES), ids=str)
def test_bilinear_plans_cover_every_output_and_nonzero_once(dims):
    """Per block: every output coordinate is one task of one warp, a warp's
    tasks in coordinate order; the repacked nonzeros are each output's own,
    in their order, every nonzero exactly once; the warps' loads are
    balanced (the heaviest within one output of the lightest); and the
    image's int sections hold the plan, the gates' and the entries' tile
    offsets."""
    actor = _actor(dims, K.HEAD_TANH)
    f = K.fold_actor(actor)
    nin, ng, nh, _ = dims
    W, P = K.actor_warps(ng), K.PITCH
    for b, (_, blk) in enumerate(actor.named_blocks()):
        idx = bilinear_index(blk.bilinear.rep, "cpu")
        rowptr = idx["rowptr"].numpy().astype(np.int64)
        nnz = np.diff(rowptr)
        wptr, task, tptr, perm = f["plans"][b]
        assert wptr[0] == 0 and wptr[-1] == ng and len(wptr) == W + 1
        assert np.all(np.diff(wptr) >= 0)
        assert sorted(task) == list(range(ng))
        for w in range(W):
            assert np.all(np.diff(task[wptr[w]:wptr[w + 1]]) > 0)
        np.testing.assert_array_equal(np.diff(tptr), nnz[task])
        for m, o in enumerate(task):
            np.testing.assert_array_equal(perm[tptr[m]:tptr[m + 1]],
                                          np.arange(rowptr[o], rowptr[o + 1]))
        assert sorted(perm) == list(range(int(nnz.sum())))
        load = [sum(int(nnz[o]) + K.TASK_COST
                    for o in task[wptr[w]:wptr[w + 1]]) for w in range(W)]
        assert max(load) - min(load) <= int(nnz.max()) + K.TASK_COST
        for name, ref in (("wptr", wptr), ("task", task), ("tptr", tptr)):
            np.testing.assert_array_equal(
                _np(K.section(f, f"{name}{b}", len(ref), True)), ref)
        gate = _np(K.section(f, f"gate{b}", nh, True))
        np.testing.assert_array_equal(gate, f["blocks"][b][3].numpy() * P)
        ent = _np(K.section(f, f"ent{b}", 2 * len(perm), True))
        np.testing.assert_array_equal(ent[0::2] >> 16,
                                      idx["j"].numpy()[perm] * P)
        np.testing.assert_array_equal(ent[0::2] & 0xFFFF,
                                      idx["i"].numpy()[perm] * P)
    assert f["nnz"] == tuple(len(p[3]) for p in f["plans"])


@pytest.mark.parametrize("head", sorted(HEADS), ids=HEADS.get)
@pytest.mark.parametrize("dims", sorted(INSTANCES), ids=str)
def test_image_holds_the_parameters(dims, head):
    """The layout's sections are 16-byte aligned, in order, apart and
    inside the image (a head's missing sections -1); the image's float
    sections are the fold's ``W_eff`` (transposed, zero-padded to a float4
    multiple), ``b_eff``, the nonzeros' v in the plan's order and the
    head's parameters, exactly; the launch's shared memory fits the default
    48 KB."""
    actor = _actor(dims, head)
    f = K.fold_actor(actor)
    nin, ng, nh, nact = dims
    lay, ngp = f["layout"], -(-ng // 4) * 4
    at = [lay[n] for n in K.META[:-2] if lay[n] >= 0]
    assert all(a % 4 == 0 for a in at) and at == sorted(at)
    assert lay["words"] % 4 == 0 and lay["words"] == f["image"].numel()
    assert list(f["meta"]) == [lay[n] for n in K.META]
    missing = {K.HEAD_TANH: ("wl", "bl", "log_std"),
               K.HEAD_GAUSS: ("log_std",), K.HEAD_PPO: ("wl", "bl")}[head]
    assert [n for n in K.HEAD_SECTIONS if lay[n] < 0] == list(missing)
    assert K.actor_smem(dims, lay) <= 48 * 1024
    for b, ni in enumerate((nin, nh)):
        W, bias, (*_, v), _ = f["blocks"][b]
        wt = K.section(f, f"wt{b}", ni * ngp).view(ni, ngp)
        assert torch.equal(wt[:, :ng], W.T) and not wt[:, ng:].any()
        assert torch.equal(K.section(f, f"b{b}", ngp)[:ng], bias)
        n = f["nnz"][b]
        ent = K.section(f, f"ent{b}", 2 * n, True)
        perm = torch.as_tensor(f["plans"][b][3])
        assert torch.equal(ent.view(torch.float32)[1::2], v[perm])
    Wh, bh = f["head"]
    assert torch.equal(K.section(f, "wh", nact * nh).view(nact, nh), Wh)
    assert torch.equal(K.section(f, "bh", nact), bh)
    if head == K.HEAD_GAUSS:
        ls = actor.log_std_linear
        assert torch.equal(K.section(f, "wl", nact * nh).view(nact, nh),
                           ls.kernel.T)
        assert torch.equal(K.section(f, "bl", nact), ls.bias)
    if head == K.HEAD_PPO:
        assert torch.equal(K.section(f, "log_std", nact),
                           actor.log_std.reshape(-1))


@pytest.mark.parametrize("dims", sorted(INSTANCES), ids=str)
def test_plan_and_image_rebuilt_when_param_version_moves(dims):
    """The fold (plan, image, meta) is cached until ``param_version``
    moves: a write the version does not see refolds nothing; a bump
    refolds exactly once, with the same plan and int sections and the new
    parameters in the image."""
    actor = _actor(dims, K.HEAD_PPO)
    f1 = K.fold_actor(actor)
    folds = K.fold_actor.folds
    with torch.no_grad():
        actor.network.block0.linear.kernel.mul_(1.5)
        actor.log_std.add_(0.25)
    assert K.fold_actor(actor) is f1 and K.fold_actor.folds == folds
    actor.bump_version()
    f2 = K.fold_actor(actor)
    assert f2 is not f1 and K.fold_actor.folds == folds + 1
    assert K.fold_actor(actor) is f2 and K.fold_actor.folds == folds + 1
    for p1, p2 in zip(f1["plans"], f2["plans"]):
        for a1, a2 in zip(p1, p2):
            np.testing.assert_array_equal(a1, a2)
    assert list(f1["meta"]) == list(f2["meta"])
    nin, ng, nh, nact = dims
    lay = f2["layout"]
    for name, n in (("wptr0", K.actor_warps(ng) + 1), ("task1", ng),
                    ("gate0", nh)):
        assert torch.equal(K.section(f1, name, n, True),
                           K.section(f2, name, n, True))
    ngp = -(-ng // 4) * 4
    W = f2["blocks"][0][0]
    assert torch.equal(K.section(f2, "wt0", nin * ngp).view(nin, ngp)[:, :ng],
                       W.T)
    assert not torch.equal(W, f1["blocks"][0][0])
    assert torch.equal(K.section(f2, "log_std", nact),
                       actor.log_std.reshape(-1))
    assert lay["words"] == f1["layout"]["words"]


# ---------------------------------------------------------------------------
# The kernel's order of summation
# ---------------------------------------------------------------------------
def emulate(folded, obs, head, noise=None, max_action=1.0):
    """``(action, log-prob)`` as the kernel computes them, read from the
    image: per block, each warp's 4 linear outputs summed over the inputs in
    order, then the bias; each warp's plan outputs (``wptr``, ``task``,
    ``tptr``), each ``0.1 q + lin`` with q its repacked nonzeros ``v lin_j
    lin_i`` summed in order; the gate ``pre / (1 + exp(-pre[g]))``; the
    head's dot products in order.  Rows are a tile's lanes and independent,
    so all rows go at once; each output is one warp's, so no partials are
    combined across warps.  The log-prob is zeros but for the PPO head."""
    nin, ng, nh, nact = folded["dims"]
    dt = folded["head"][0].dtype
    P, ngp = K.PITCH, -(-ng // 4) * 4
    x = obs.to(dt)
    rows = x.shape[0]
    for b, ni in enumerate((nin, nh)):
        Wt = K.section(folded, f"wt{b}", ni * ngp).view(ni, ngp)
        bias = K.section(folded, f"b{b}", ngp)
        lin = x.new_zeros(rows, ngp)
        for q4 in range(ngp // 4):            # warp q4 % warps
            acc = x.new_zeros(rows, 4)
            for k in range(ni):
                acc = acc + x[:, k:k + 1] * Wt[k, 4 * q4:4 * q4 + 4]
            lin[:, 4 * q4:4 * q4 + 4] = acc + bias[4 * q4:4 * q4 + 4]
        lin = lin[:, :ng]
        wptr, task, tptr = (_np(K.section(folded, f"{n}{b}", m, True))
                            for n, m in (("wptr", folded["layout"]["warps"]
                                          + 1), ("task", ng), ("tptr", ng + 1)))
        ent = K.section(folded, f"ent{b}", 2 * int(tptr[-1]), True)
        off, v = _np(ent[0::2]), ent.view(dt)[1::2]
        pre = x.new_zeros(rows, ng)
        for w in range(len(wptr) - 1):
            for m in range(wptr[w], wptr[w + 1]):
                o, q = task[m], x.new_zeros(rows)
                for e in range(tptr[m], tptr[m + 1]):
                    j, i = (off[e] >> 16) // P, (off[e] & 0xFFFF) // P
                    q = q + v[e] * lin[:, j] * lin[:, i]
                pre[:, o] = 0.1 * q + lin[:, o]
        gate = torch.as_tensor(_np(K.section(folded, f"gate{b}", nh, True))
                               // P)
        x = pre[:, :nh] / (1.0 + torch.exp(-pre[:, gate]))

    def dot(name, a):
        w = K.section(folded, name, nact * nh).view(nact, nh)[a]
        s = x.new_zeros(rows)
        for k in range(nh):
            s = s + x[:, k] * w[k]
        return s
    act, logp = x.new_zeros(rows, nact), x.new_zeros(rows, nact)
    bh = K.section(folded, "bh", nact)
    for a in range(nact):                     # warp a
        mean = dot("wh", a) + bh[a]
        if head == K.HEAD_PPO:
            mu = torch.tanh(mean)
            ls = K.section(folded, "log_std", nact)[a]
            if noise is None:
                act[:, a] = torch.clamp(mu, -max_action, max_action)
                continue
            sd = torch.exp(ls)
            act[:, a] = torch.clamp(mu + sd * noise[:, a].to(dt), -max_action,
                                    max_action)
            z = (act[:, a] - mu) / sd
            logp[:, a] = -0.5 * (z * z) - ls - 0.5 * np.log(2 * np.pi)
            continue
        pre_a = mean
        if head == K.HEAD_GAUSS and noise is not None:
            ls = torch.clamp(dot("wl", a) + K.section(folded, "bl", nact)[a],
                             -20.0, 2.0)
            pre_a = mean + torch.exp(ls) * noise[:, a].to(dt)
        act[:, a] = torch.tanh(pre_a)
    return act, logp


def _plain(actor, head, obs, noise):
    """The plain twin's ``(action, log-prob)`` (zeros but for PPO)."""
    with torch.no_grad():
        if head == K.HEAD_TANH:
            a = K.emlp_actor_plain(actor, obs)
        elif head == K.HEAD_GAUSS:
            a = K.sac_actor_plain(actor, obs, noise)
        else:
            return K.ppo_actor_plain(actor, obs, noise)
    return a, torch.zeros_like(a)


@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("head", sorted(HEADS), ids=HEADS.get)
@pytest.mark.parametrize("dims", sorted(INSTANCES), ids=str)
def test_kernel_order_matches_the_twins(dims, head, B):
    """The emulated kernel against the plain twin at ``B`` rows (partial
    tiles, one, just over one, eight), in train mode (N(0, 1) draws, some
    large enough to clip) and eval mode: float64 within 1e-12, float32
    within the kernel's tolerances."""
    nin, _, _, nact = dims
    rng = np.random.default_rng(100 * B + nin + head)
    obs = torch.as_tensor(rng.normal(0, 0.7, (B, nin)))
    noise = torch.as_tensor(rng.normal(0, 1.0, (B, nact)))
    noise[::3] *= 3.0
    for dtype in (torch.float64, torch.float32):
        actor = _actor(dims, head, dtype, seed=B)
        f = K.fold_actor(actor)
        o, nz = obs.to(dtype), noise.to(dtype)
        for mode, draw in (("train", nz), ("eval", None)):
            if head == K.HEAD_TANH and draw is not None:
                continue
            ka, kl = emulate(f, o, head, draw, actor.max_action
                             if head == K.HEAD_PPO else 1.0)
            pa, pl = _plain(actor, head, o, draw)
            if dtype == torch.float64:
                _close(_np(ka), _np(pa), 1e-12, f"{mode} action")
                _close(_np(kl), _np(pl), 1e-12, f"{mode} logp", floor=1.0)
            else:
                _close(_np(ka), _np(pa), 1e-5, f"{mode} action", floor=1.0)
                _close(_np(kl), _np(pl), 2e-5, f"{mode} logp", floor=1.0)
            if head == K.HEAD_PPO and mode == "train" and B >= 32:
                assert (pa.abs() == actor.max_action).any()


# ---------------------------------------------------------------------------
# Against the flax actors
# ---------------------------------------------------------------------------
def _np_tree(x):
    return jax.tree.map(np.asarray, serialization.to_state_dict(x))


def _to64(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float64)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


@functools.lru_cache(maxsize=None)
def _flax(dims, head):
    """(flax module, float32 params, JAX agent or None) of ``dims`` and
    ``head``; the PPO actor's ``log_std`` at 0.3, so the draws clip."""
    fw, agent = INSTANCES[dims]
    jcfg = JConfig(framework=fw)
    obs0 = jnp.zeros((1, dims[0]), jnp.float32)
    if head == K.HEAD_TANH:
        mod = jzoo.EMLPActorDet(*jzoo.actor_reps(jcfg, fw, agent))
        return mod, mod.init(jax.random.PRNGKey(5 + agent), obs0), None
    if head == K.HEAD_GAUSS:
        models = jzoo.sac_models(jcfg, agent)
        jagent = jsac.SACAgent(jcfg, agent, models)
    else:
        models = jzoo.ppo_models(jcfg, agent)
        jagent = jppo.PPOAgent(jcfg, agent, models)
    params = models.actor_def.init(jax.random.PRNGKey(5 + agent), obs0)
    if head == K.HEAD_PPO:
        params["params"]["log_std"] = jnp.full((1, dims[3]), 0.3, jnp.float32)
    return models.actor_def, params, jagent


@pytest.mark.parametrize("head", sorted(HEADS), ids=HEADS.get)
@pytest.mark.parametrize("dims", sorted(INSTANCES), ids=str)
def test_kernel_order_matches_flax(dims, head):
    """The emulated kernel (float32 weights from flax's init) against the
    flax actor in float64 on 33 rows: the tanh actor's output; the SAC and
    PPO agents' ``choose_action_f`` in train mode with their own key, whose
    draw is handed to the emulation, and in eval mode."""
    fw, agent = INSTANCES[dims]
    tcfg = TConfig(framework=fw)
    mod, params, jagent = _flax(dims, head)
    conv = {K.HEAD_TANH: convert.actor_params_from_jax,
            K.HEAD_GAUSS: convert.sac_actor_params_from_jax,
            K.HEAD_PPO: convert.ppo_actor_params_from_jax}[head]
    actor = _make(head, tcfg, fw, agent)
    actor.load_state_dict(conv(_np_tree(params), tcfg, agent))
    f = K.fold_actor(actor)
    rng = np.random.default_rng(7 + dims[0])
    obs = rng.normal(0, 0.7, (33, dims[0])).astype(np.float32)
    p64 = _to64(params)
    jobs = jnp.asarray(obs, jnp.float64)
    if head == K.HEAD_TANH:
        ref = np.asarray(mod.apply(p64, jobs))
        ka, _ = emulate(f, torch.as_tensor(obs), head)
        _close(_np(ka), ref, 1e-5, "action", floor=1.0)
        return
    key = jax.random.PRNGKey(11 + dims[0])
    for is_eval in (False, True):
        out = jagent.choose_action_f(p64, jobs, key, is_eval)
        ja, jl = out if head == K.HEAD_PPO else (out, None)
        noise = None if is_eval else torch.as_tensor(np.array(
            jax.random.normal(key, ja.shape, jnp.float64)))
        ka, kl = emulate(f, torch.as_tensor(obs), head, noise,
                         tcfg.max_action if head == K.HEAD_PPO else 1.0)
        _close(_np(ka), np.asarray(ja), 1e-5, f"action eval={is_eval}",
               floor=1.0)
        if jl is not None:
            _close(_np(kl), np.asarray(jl), 2e-5, f"logp eval={is_eval}",
                   floor=1.0)
