"""K12 (GAE) in one launch and the MLP PPO actor's acting forward fused
with K11's head, on the CPU: K12's launch plan, a torch emulation of its
fixed order of summation held to JAX's ``ppo.gae``, the fused actor's plain
twin held to flax's ``ActorPPO`` with ``gaussian_logprob``, and an
emulation of the fused kernel's dot-product order.

``kernels/csrc/gae.cu``: CTAs of ``cols`` env columns (``gae_plan``);
thread i of a CTA of nc columns takes column i mod nc of rows i // nc,
i // nc + R, ... (R = threads // nc; threads from R nc on take none); its
term of the mean is those raw advantages added in order (the tiles
emulated here stay in shared memory: one chunk), of the variance their
(adv - m)^2; a CTA adds its threads' terms by a warp
butterfly (``v += v[lane ^ h]``, h = 16 .. 1), then its warps' sums by the
same butterfly; the CTAs' sums meet in rank order (a cluster: lane l holds
CTA l's sum, then the butterfly; a grid: lane l adds CTAs l, l + 32, ...
in order, then the butterfly).  The recursion and the
TD targets keep the plain twin's expression, so ``td`` is bitwise.
``kernels/csrc/mlp_ppo_actor.cu``: each hidden unit and each mean is
``x[0] W[0] + x[1] W[1] + ...`` in input order, then the bias (then relu),
each product and sum rounded once (``-fmad=false``).

Tolerances (float32 where the kernels' arithmetic is emulated, as they
run): K12's normalised advantages within 1e-5 max(1, max |ref|) of JAX's
float32 ``gae`` under ``jit`` (the tolerance the card's kernel is held to
against the twin; the sums over up to 204 800 entries differ in order), the
TD targets within 1e-6 max(1, max |ref|) (XLA may contract the recursion's
multiply-add) and bitwise ``gae_plain``'s.  The fused actor's twin in
float64 within 1e-12 of flax's (actions) and its log-probs within 1e-12 of
the largest; the float32 emulation within 1e-5 (actions) and 2e-5 max(1,
max |ref|) (log-probs) of flax's float32 forward, the card's tolerances.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_rotor_tpu.algos import ppo as jppo
from gym_rotor_tpu.models import mlp as jmlp
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch import convert
from gym_rotor_tpu_torch.algos import ppo as tppo
from gym_rotor_tpu_torch.kernels import gae as K12
from gym_rotor_tpu_torch.kernels import mlp_ppo_actor as KM
from gym_rotor_tpu_torch.models import mlp as tmlp
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from test_torch_optim_loss_kernel import _butterfly
from test_torch_td3 import _close, _np, _t

torch.set_num_threads(1)

PLAN_B = (1, 31, 32, 33, 256, 257, 4096, 4097)
PLAN_T = (1, 50, 218, 7000)
SMEM_LIMIT = 232448           # 227 KB of shared memory a block
STATIC_SMEM = 2048            # the kernel's static shared memory at most
CLUSTER_LIMIT = 16
# the MLP PPO actors the port builds: (config keywords, agent, dims)
MLP_ACTORS = (({}, 0, (15, 16, 4)), ({}, 1, (3, 4, 1)),
              ({"framework": "MONO"}, 0, (23, 16, 4)))
ROWS = (1, 10, 32)


# ---------------------------------------------------------------------------
# K12's launch plan
# ---------------------------------------------------------------------------
def _check_plan(plan, T, B):
    assert plan.ctas * plan.cols >= B > (plan.ctas - 1) * plan.cols, plan
    starts = np.arange(plan.ctas) * plan.cols
    cols = np.concatenate([np.arange(s, min(s + plan.cols, B))
                           for s in starts])
    assert np.array_equal(cols, np.arange(B))       # each column once
    assert plan.cols <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.rows * plan.chunks >= T > plan.rows * (plan.chunks - 1)
    assert 1 <= plan.stages <= K12.MAX_STAGES
    assert plan.resident == (plan.stages == plan.chunks)
    smem = plan.smem(T)
    assert 0 < smem <= K12.SMEM_BYTES and smem + STATIC_SMEM <= SMEM_LIMIT
    if plan.mode == "cluster":
        assert plan.ctas <= CLUSTER_LIMIT
    if plan.mode == "grid":
        assert plan.ctas <= K12.SMS


@pytest.mark.parametrize("T,B", list(itertools.product(PLAN_T, PLAN_B)))
def test_gae_plan_covers_each_column_once(T, B):
    """Every env column is scanned by exactly one (CTA, thread); every row
    by exactly one chunk; shared memory, threads and the cluster within the
    card's limits; narrow horizons (B <= 256) in one cluster (one CTA for
    B <= 2 or fewer than ``SOLO_ENTRIES`` entries), wider ones in a grid;
    the one-CTA and one-cluster plans cover them too."""
    plan = K12.gae_plan(T, B)
    _check_plan(plan, T, B)
    assert plan.mode == ("grid" if B > K12.NARROW_COLS else
                         "cluster" if B > K12.NARROW_CLUSTER_COLS
                         and T * B >= K12.SOLO_ENTRIES else "solo")
    if B <= K12.NARROW_COLS:
        _check_plan(K12.gae_plan(T, B, mode="solo"), T, B)
    else:
        _check_plan(K12.gae_plan(T, B, mode="cluster"), T, B)


def test_gae_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError):
        K12.gae_plan(0, 5)
    with pytest.raises(ValueError):
        K12.gae_plan(50, K12.SMS * 1024 + 1)
    with pytest.raises(ValueError):
        K12.gae_plan(50, 4096, mode="cluster", cols=32)


# ---------------------------------------------------------------------------
# K12's order of summation vs JAX
# ---------------------------------------------------------------------------
def _block_total(terms, threads):
    """(ctas, threads) per-thread terms -> each CTA's sum: a warp
    butterfly, then the warps' sums by the butterfly (zero past them)."""
    ctas = terms.shape[0]
    warps = _butterfly(terms.reshape(ctas, threads // 32, 32))
    pad = torch.zeros(ctas, 32, dtype=terms.dtype)
    pad[:, :warps.shape[1]] = warps
    return _butterfly(pad)


def _cross_total(sums, mode):
    """The CTAs' sums in rank order (every CTA gets the same)."""
    if mode == "solo":
        return sums[0]
    if mode == "cluster":
        pad = torch.zeros(32, dtype=sums.dtype)
        pad[:sums.shape[0]] = sums
        return _butterfly(pad)
    lanes = torch.zeros(32, dtype=sums.dtype)
    for j in range(sums.shape[0]):        # lane j % 32, in CTA order
        lanes[j % 32] = lanes[j % 32] + sums[j]
    return _butterfly(lanes)


def gae_emulated(v, nv, r, d, gamma, lam, plan):
    """K12's arithmetic in float32 torch on ``(T, B)`` inputs:
    ``(normalised advantages, td)``."""
    T, B = v.shape
    f32 = torch.float32
    carry = torch.zeros(B, dtype=f32)
    raw = torch.empty(T, B, dtype=f32)
    for t in range(T - 1, -1, -1):
        nd = 1.0 - d[t]
        delta = r[t] + gamma * nv[t] * nd - v[t]
        carry = delta + gamma * nd * lam * carry
        raw[t] = carry
    td = raw + v
    n = T * B
    th, C = plan.threads, plan.ctas

    def terms(fn):
        """Per CTA and thread, fn of its entries added in order."""
        out = torch.zeros(C, th, dtype=f32)
        for k in range(C):
            nc = min(plan.cols, B - k * plan.cols)
            R = th // nc
            steps = -(-T // R)
            tile = torch.zeros(steps * R, nc, dtype=f32)
            tile[:T] = raw[:, k * plan.cols:k * plan.cols + nc]
            mask = (torch.arange(steps * R) < T)[:, None].expand(-1, nc)
            # step s, thread i = t0 nc + c: row t0 + s R, column c
            x = fn(tile).reshape(steps, R * nc)
            mask = mask.reshape(steps, R * nc)
            acc = torch.zeros(R * nc, dtype=f32)
            for s in range(steps):
                acc = torch.where(mask[s], acc + x[s], acc)
            out[k, :R * nc] = acc
        return out

    m = _cross_total(_block_total(terms(lambda e: e), th), plan.mode) \
        / np.float32(n)
    var = _cross_total(_block_total(terms(lambda e: (e - m) * (e - m)), th),
                       plan.mode) / np.float32(n)
    dof = max(n - 1, 1)
    denom = torch.sqrt(var * np.float32(n) / np.float32(dof)) \
        + np.float32(1e-4)
    return (raw - m) / denom, td


@pytest.mark.parametrize("T,B,kw", [
    (218, 32, {}), (218, 32, dict(mode="solo")), (50, 64, {}),
    (50, 4096, {}), (50, 4096, dict(mode="cluster")),
    (50, 4096, dict(mode="grid", cols=32)), (7000, 1, {})])
def test_gae_order_vs_jax(T, B, kw):
    """The kernel's fixed order, emulated in float32, vs JAX's ``gae``
    under ``jit`` in float32 on the same horizon (~5% dones): PPO A's
    (218, 32) in the chosen plan (one cluster) and in one CTA, (50, 64),
    PPO B's (50, 4096) in the chosen plan (a grid of 64 CTAs), in one
    cluster and in a grid of 128 CTAs, and a 7000-step chain; ``td``
    bitwise ``gae_plain``'s."""
    jcfg = JConfig(rl_algo="PPO")
    gamma, lam = jcfg.discount, jcfg.GAE_lambda
    rng = np.random.default_rng(T + B)
    v, nv, r = (rng.normal(size=(T, B)).astype(np.float32)
                for _ in range(3))
    d = (rng.uniform(size=(T, B)) < 0.05).astype(np.float32)
    plan = K12.gae_plan(T, B, **kw)
    assert plan.mode == kw.get("mode", "solo" if B == 1 else
                               "cluster" if B <= 256 else "grid")
    assert K12.gae_plan(1, 7).mode == "solo"
    ea, et = gae_emulated(*map(torch.from_numpy, (v, nv, r, d)), gamma, lam,
                          plan)
    ja, jt = jax.jit(lambda *x: jppo.gae(jcfg, *x))(
        *(jnp.asarray(a[..., None]) for a in (v, nv, r, d)))
    assert ja.dtype == jnp.float32
    scale = max(1.0, float(np.abs(np.asarray(ja)).max()))
    assert float(np.abs(_np(ea) - np.asarray(ja)[..., 0]).max()) <= 1e-5 * scale
    tscale = max(1.0, float(np.abs(np.asarray(jt)).max()))
    assert float(np.abs(_np(et) - np.asarray(jt)[..., 0]).max()) <= 1e-6 * tscale
    pa, pt = K12.gae_plain(*map(torch.from_numpy, (v, nv, r, d)), gamma, lam)
    assert torch.equal(et, pt)
    pscale = max(1.0, float(pa.abs().max()))
    assert float((ea - pa).abs().max()) <= 1e-5 * pscale


# ---------------------------------------------------------------------------
# The MLP PPO actor
# ---------------------------------------------------------------------------
def _flax_actor(kw, agent, dims, log_std):
    """Flax's ``ActorPPO`` of ``dims`` (seeded), its float64 params with
    ``log_std`` set, and the port's ``ActorPPO`` through the converter."""
    nin, nh, nact = dims
    jdef = jmlp.ActorPPO(hidden_dim=nh, action_dim=nact)
    params = jdef.init(jax.random.PRNGKey(sum(dims)), jnp.zeros((1, nin)))
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    params["params"]["log_std"] = np.asarray(log_std, np.float64)
    tcfg = TConfig(rl_algo="PPO", use_equiv=False, **kw)
    assert (tcfg.obs_dim_n[agent], tcfg.actor_hidden_dim[agent],
            tcfg.action_dim_n[agent]) == dims
    actor = tmlp.ActorPPO(nin, nh, nact, max_action=tcfg.max_action,
                          device="cpu", dtype=torch.float64)
    actor.load_state_dict(convert.ppo_actor_params_from_jax(params, tcfg,
                                                            agent))
    return jdef, params, actor, tcfg.max_action


def _jax_draw(jdef, params, obs, noise, m):
    mean, log_std = jdef.apply(params, obs)
    if noise is None:
        a = jnp.clip(mean, -m, m)
        return a, jnp.zeros_like(a)
    a = jnp.clip(mean + jnp.exp(log_std) * noise, -m, m)
    return a, jmlp.gaussian_logprob(mean, log_std, a)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("kw,agent,dims", MLP_ACTORS)
def test_mlp_ppo_actor_plain_twin_matches_flax(kw, agent, dims, rows):
    """``mlp_ppo_actor_plain`` (``actor_ppo_pre`` + K11's head) vs flax's
    ``ActorPPO`` with the clipped draw and ``gaussian_logprob`` (ppo.py:
    107-116) on injected noise, float64, ``log_std`` from -1 to 2.5 (the
    wide end clips), and the eval branch (``clip(mean)``, zeros); through
    ``ActorPPO.forward`` into column slices of wider tensors."""
    nin, _, nact = dims
    ls = np.linspace(-1.0, 2.5, nact)[None, :]
    jdef, params, actor, m = _flax_actor(kw, agent, dims, ls)
    rng = np.random.default_rng(rows + nin)
    obs = rng.normal(0, 0.6, (rows, nin))
    noise = rng.normal(size=(rows, nact))
    for nz in (noise, None):
        ja, jl = _jax_draw(jdef, params, jnp.asarray(obs),
                           None if nz is None else jnp.asarray(nz), m)
        ta, tl = KM.mlp_ppo_actor_plain(actor, _t(obs),
                                        None if nz is None else _t(nz))
        _close(_np(ta), ja, 1e-12, "action")
        _close(_np(tl), jl, 1e-12, "logp")
        out = torch.full((rows, nact + 2), 7.0, dtype=torch.float64)
        lpo = torch.full_like(out, 7.0)
        with torch.no_grad():
            actor(_t(obs), None if nz is None else _t(nz),
                  out[:, 1:1 + nact], lpo[:, 1:1 + nact])
        assert torch.equal(out[:, 1:1 + nact], ta)
        assert torch.equal(lpo[:, 1:1 + nact], tl)
        assert bool((out[:, [0, -1]] == 7.0).all()
                    and (lpo[:, [0, -1]] == 7.0).all())
        if nz is None:
            assert not _np(tl).any()


def _dense_emulated(x, W, b, relu):
    """``x W + b`` with each output ``x[0] W[0] + x[1] W[1] + ...`` in
    input order, then the bias (the kernel's order), float32."""
    acc = x[:, :1] * W[:1]
    for k in range(1, W.shape[0]):
        acc = acc + x[:, k:k + 1] * W[k:k + 1]
    acc = acc + b
    return torch.clamp_min(acc, 0.0) if relu else acc


@pytest.mark.parametrize("kw,agent,dims", MLP_ACTORS)
def test_mlp_ppo_actor_order_vs_flax(kw, agent, dims):
    """The fused kernel's arithmetic (each dot product in input order, then
    the bias; K11's head as the plain twin's), emulated in float32 at 32
    rows, vs flax's float32 forward with the draw and the log-prob: within
    the card's tolerances."""
    nin, _, nact = dims
    ls = np.linspace(-1.0, 2.5, nact)[None, :]
    jdef, params, actor, m = _flax_actor(kw, agent, dims, ls)
    p32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    rng = np.random.default_rng(nin)
    obs = rng.normal(0, 0.6, (32, nin)).astype(np.float32)
    noise = rng.normal(size=(32, nact)).astype(np.float32)
    w = {k: v.detach().float() for k, v in actor.params().items()}
    x = torch.from_numpy(obs)
    h = _dense_emulated(x, w["Dense_0.kernel"], w["Dense_0.bias"], True)
    h = _dense_emulated(h, w["Dense_1.kernel"], w["Dense_1.bias"], True)
    pre = _dense_emulated(h, w["mean.kernel"], w["mean.bias"], False)
    from gym_rotor_tpu_torch.kernels.emlp_actor import ppo_head_plain
    for nz in (noise, None):
        ea, el = ppo_head_plain(pre, w["log_std"],
                                None if nz is None else torch.from_numpy(nz),
                                m)
        ja, jl = _jax_draw(jdef, p32, jnp.asarray(obs),
                           None if nz is None else jnp.asarray(nz), m)
        assert ja.dtype == jnp.float32
        assert float(np.abs(_np(ea) - np.asarray(ja)).max()) <= 1e-5
        scale = max(1.0, float(np.abs(np.asarray(jl)).max()))
        assert float(np.abs(_np(el) - np.asarray(jl)).max()) <= 2e-5 * scale


def test_cpu_paths_launch_nothing():
    """``ActorPPO.forward`` and ``ppo.gae`` on CPU tensors run the plain
    twins: no kernel wrapper counts a launch."""
    from gym_rotor_tpu_torch.kernels import (emlp_actor, emlp_block,
                                             env_tick, flat_adamw, ppo_loss,
                                             replay, sac_sample, spectral)
    mods = (emlp_actor, emlp_block, env_tick, flat_adamw, K12, KM, ppo_loss,
            replay, sac_sample, spectral)
    wrappers = [getattr(mod, w) for mod in mods for w in mod.WRAPPERS]
    before = [w.launches for w in wrappers]
    actor = tmlp.ActorPPO(15, 16, 4, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    obs = torch.randn(32, 15)
    with torch.no_grad():
        a, lp = actor(obs, torch.randn(32, 4))
        ae, le = actor(obs)
    assert a.shape == lp.shape == ae.shape == (32, 4) and not le.any()
    v = torch.randn(218, 32, 1)
    adv, td = tppo.gae(TConfig(rl_algo="PPO"), v, v, v,
                       torch.zeros_like(v))
    assert adv.shape == td.shape == (218, 32, 1)
    assert [w.launches for w in wrappers] == before
