"""K6 (the flat clip + AdamW + Polyak step) and K13 (PPO's surrogate,
forward and backward) as one launch each, on the CPU: their launch plans,
and a torch emulation of each kernel's fixed order of summation held to
the JAX arithmetic it replaces.

``kernels/csrc/flat_adamw.cu``: G clusters of C blocks of T threads
(``flat_adamw_plan``); thread q of a cluster owns the slots k of elements
``q + k C T``, cluster c the slots ``[c E, c E + E)``; every cluster sums
the squares of all slots ``0 .. G E - 1`` per thread in slot order, then a
warp butterfly (``v += v[lane ^ h]``, h = 16 .. 1), the block's warps' sums
by the same butterfly (zero past the warps), the cluster's blocks' sums by
it again (zero past C).  ``kernels/csrc/ppo_loss.cu``: one block or one
cluster (``ppo_loss_plan``); thread q takes rows ``q, q + C T, ...`` and
adds their terms in row order, then the same three butterflies.

Tolerances (float32 throughout, as the kernels run).
- K6: the emulated step (the gradient clipped by the kernel-order norm,
  then the plain twin unclipped) vs
  optax's ``clip_by_global_norm`` -> ``adamw`` chain from the JAX package's
  ``make_optimizer``, two steps: p, mu, nu within 1e-6 max(1, max |ref|)
  (the tolerance the card's kernel is held to against the twin); the
  emulated norm within 1e-6 relative of the float64 norm.  Only the
  norm's summation order differs, so on the clip boundary either branch
  is within the tolerance.
- K13: the emulated loss and ``g_log_std`` vs ``jax.value_and_grad`` of
  ``ppo.py:250-258``'s surrogate: within 2e-5 max(1, max |ref|); ``g_mean``
  (per row, no sum) within the same, on rows inside and outside the clip
  range, with zero advantages and (one action) exactly at ``1 +- 0.2`` in
  both libraries' float32 arithmetic.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_rotor_tpu.algos import common as jcommon
from gym_rotor_tpu.models import mlp as jmlp
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch.algos import common as tcommon
from gym_rotor_tpu_torch.kernels import flat_adamw as K6
from gym_rotor_tpu_torch.kernels import ppo_loss as K13
from gym_rotor_tpu_torch.models.mlp import gaussian_entropy
from gym_rotor_tpu_torch.utils.config import Config as TConfig

torch.set_num_threads(1)

# every flat vector a learner steps: actor and critic of each agent of TD3,
# SAC and PPO on MODUL DTDE and CTDE and MONO, EMLP and MLP networks
# (test_real_sizes_are_the_learners rebuilds the list)
REAL_SIZES = (41, 42, 46, 122, 123, 127, 596, 600, 664, 724, 728, 792, 854,
              858, 922, 998, 1002, 1066, 4217, 4961, 5147, 5457, 8558, 9068,
              9281, 9636, 10418, 10914, 11410, 18704, 19272, 19840, 27092,
              28937, 54430, 59104)
# one element, a block's edges, the last size of solo blocks and the first
# of clusters, past the register path and past one pass of the plan
K6_EDGES = (1, 255, 256, 257, 2048, 2049, 131072, 131073, 1000003)
K13_ROWS = (1, 127, 128, 129, 256, 257, 3723, 4096, 4097, 16384, 20000,
            70001)


# ---------------------------------------------------------------------------
# Launch plans
# ---------------------------------------------------------------------------
def _is_pow2(x):
    return x >= 1 and x & (x - 1) == 0


@pytest.mark.parametrize("n", K6_EDGES + REAL_SIZES)
def test_flat_adamw_plan_covers_each_element_once(n):
    """Every element is owned by exactly one (cluster, thread, slot) and
    summed exactly once by every cluster; clusters are powers of two up to
    16, blocks multiples of 32 up to 1024 threads."""
    G, C, T, E = plan = K6.flat_adamw_plan(n)
    assert _is_pow2(C) and C <= 16 and 1 <= G <= K6.MAX_CLUSTERS
    assert T % 32 == 0 and 32 <= T <= 1024 and E >= 1
    assert G * C * T * E >= n and G * C * T * (E - 1) < n, plan
    S = C * T
    q = np.arange(S)
    owned = np.concatenate([q[:, None] + (c * E + np.arange(E)) * S
                            for c in range(G)], axis=None)
    owned = owned[owned < n]
    assert np.array_equal(np.sort(owned), np.arange(n))
    summed = (q[:, None] + np.arange(G * E) * S).ravel()
    assert np.array_equal(np.sort(summed[summed < n]), np.arange(n))
    if n <= K6.SOLO_ELEMS:
        assert C == 1
    if n <= 131072:     # the register path: one element a thread
        assert E == 1


def test_real_sizes_are_the_learners():
    from gym_rotor_tpu_torch.algos.ppo import PPOAgent
    from gym_rotor_tpu_torch.algos.sac import SACAgent
    from gym_rotor_tpu_torch.algos.td3 import TD3Agent
    sizes = set()
    for algo, cls in (("TD3", TD3Agent), ("SAC", SACAgent),
                      ("PPO", PPOAgent)):
        for kw in ({}, {"framework": "MONO"}, {"module_training": "CTDE"}):
            for equiv in (True, False):
                cfg = TConfig(rl_algo=algo, use_equiv=equiv, **kw)
                for i in range(cfg.n_agents):
                    a = cls(cfg, i, device="cpu")
                    sizes |= {a.actor_layout.size, a.critic_layout.size}
    assert tuple(sorted(sizes)) == REAL_SIZES


@pytest.mark.parametrize("B", K13_ROWS)
def test_ppo_loss_plan_covers_each_row_once(B):
    """Every row is taken by exactly one (thread, pass); one block up to
    ``BLOCK_ROWS`` rows, else one power-of-two cluster of up to 16."""
    C, T, R = plan = K13.ppo_loss_plan(B)
    assert _is_pow2(C) and C <= 16 and T % 32 == 0 and 32 <= T <= 1024
    assert C * T * R >= B and C * T * (R - 1) < B, plan
    assert (C == 1) == (B <= K13.BLOCK_ROWS)
    rows = (np.arange(C * T)[:, None] + np.arange(R) * C * T).ravel()
    assert np.array_equal(np.sort(rows[rows < B]), np.arange(B))


# ---------------------------------------------------------------------------
# The kernels' order of summation
# ---------------------------------------------------------------------------
def _butterfly(x):
    """``x`` (..., 32) summed over the last dim as a warp does: ``v +=
    v[lane ^ h]`` for h = 16 .. 1; the sum every lane holds."""
    lane = torch.arange(32)
    h = 16
    while h:
        x = x + x[..., lane ^ h]
        h //= 2
    return x[..., 0]


def _pad32(x):
    """``x`` (..., m, W), m <= 32, with zero rows up to 32, lanes last:
    (..., W, 32)."""
    pad = x.new_zeros(*x.shape[:-2], 32 - x.shape[-2], x.shape[-1])
    return torch.cat([x, pad], -2).transpose(-1, -2)


def _block_then_cluster(acc, C, T):
    """Per-thread sums ``acc`` (C T, W) of one cluster: the warp butterfly,
    the block's warps' sums (zero past them), then the blocks' (zero past
    C): (W,)."""
    W = acc.shape[-1]
    lanes = acc.view(C, T // 32, 32, W).transpose(-1, -2)
    warps = _butterfly(lanes)                       # (C, nw, W)
    blocks = _butterfly(_pad32(warps))              # (C, W)
    return _butterfly(_pad32(blocks))               # (W,)


def k6_norm(g):
    """K6's norm of ``g`` (float32) in the kernel's order for its plan: per
    thread the squares of slots 0 .. G E - 1 in order (zero past n), then
    ``_block_then_cluster``; every cluster computes the same."""
    G, C, T, E = K6.flat_adamw_plan(g.numel())
    S = C * T
    x = torch.zeros(G * E * S, dtype=g.dtype)
    x[:g.numel()] = g
    x = x.view(G * E, S)
    acc = torch.zeros(S, dtype=g.dtype)
    for k in range(G * E):
        acc = acc + x[k] * x[k]
    return torch.sqrt(_block_then_cluster(acc[:, None], C, T)[0])


def k13_sums(rows, B):
    """``rows`` (B, W) summed in K13's order for ``ppo_loss_plan(B)``: per
    thread its rows in order (a thread with none holds zero), then
    ``_block_then_cluster``."""
    C, T, R = K13.ppo_loss_plan(B)
    S, W = C * T, rows.shape[1]
    acc = torch.zeros(S, W, dtype=rows.dtype)
    for k in range(R):
        lo, hi = k * S, min(B, (k + 1) * S)
        if hi > lo:
            acc[:hi - lo] = acc[:hi - lo] + rows[lo:hi]
    return _block_then_cluster(acc, C, T)


def test_butterfly_is_the_sum():
    x = torch.arange(32, dtype=torch.float32)
    assert float(_butterfly(x)) == float(x.sum())


# ---------------------------------------------------------------------------
# K6 vs optax
# ---------------------------------------------------------------------------
def _close(got, ref, rel, what):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = float(np.max(np.abs(got - ref)))
    tol = rel * max(1.0, float(np.max(np.abs(ref))))
    assert err <= tol, f"{what}: max err {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("n", (122, 854, 2049, 9068, 54430, 131073))
@pytest.mark.parametrize("norm", (10.0, 1000.0, "boundary"))
def test_k6_order_vs_optax(n, norm):
    """Two steps of the emulated kernel (clipped by ``k6_norm``, then the
    plain twin with no clip)
    vs ``make_optimizer``'s optax chain, float32, from optax's init: the
    gradient's norm 10 and 1000 against the clip of 100, and scaled to sit
    on it (norm == 100 in float32 by the emulation)."""
    rng = np.random.default_rng(n)
    p0 = rng.normal(size=n).astype(np.float32)
    jcfg, tcfg = JConfig(), TConfig()
    jtx = jcommon.make_optimizer(jcfg, 3e-4)
    jp = jnp.asarray(p0)
    jopt = jtx.init(jp)
    ttx = tcommon.make_optimizer(tcfg, 3e-4)
    tp = torch.from_numpy(p0.copy())
    topt = ttx.init(tp)
    for step in range(2):
        g = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        if norm == "boundary":
            g = g * (100.0 / k6_norm(g))
            for _ in range(8):       # walk the scale until the norm is 100
                k = k6_norm(g)
                if float(k) == 100.0:
                    break
                g = g * (1 - 2 ** -24 if float(k) > 100.0 else 1 + 2 ** -24)
        else:
            g = g * (norm / g.double().norm()).float()
        kn = k6_norm(g)
        assert abs(float(kn) - float(g.double().norm())) <= \
            1e-6 * float(g.double().norm())
        upd, jopt = jtx.update(jnp.asarray(g.numpy()), jopt, jp)
        jp = jp + upd
        s = ttx.scalars(topt)
        g = torch.where(kn < s.max_norm, g, (g / kn) * s.max_norm)
        K6.flat_adamw_plain(tp, g, topt.mu, topt.nu,
                            dataclasses.replace(s, max_norm=None))
        topt = tcommon.OptState(topt.count + 1, topt.mu, topt.nu,
                                topt.sched_count + 1)
        adam = jopt[1][0]
        _close(tp.numpy(), np.asarray(jp), 1e-6, f"step {step} params")
        _close(topt.mu.numpy(), np.asarray(adam.mu), 1e-6, f"step {step} mu")
        _close(topt.nu.numpy(), np.asarray(adam.nu), 1e-6, f"step {step} nu")
        assert jp.dtype == jnp.float32


# ---------------------------------------------------------------------------
# K13 vs jax.value_and_grad
# ---------------------------------------------------------------------------
CLIP = 0.2


def _jax_surrogate(mean, log_std, a, lp_old, ad, coef):
    """``ppo.py:247-258``'s surrogate, as written there."""
    log_std = jnp.broadcast_to(log_std, mean.shape)
    entropy = jnp.sum(jmlp.gaussian_entropy(log_std), axis=-1, keepdims=True)
    lp = jmlp.gaussian_logprob(mean, log_std, a)
    ratio = jnp.exp(lp.sum(-1, keepdims=True) - lp_old.sum(-1, keepdims=True))
    s1 = ratio * ad
    s2 = jnp.clip(ratio, 1.0 - CLIP, 1.0 + CLIP) * ad
    return -(jnp.minimum(s1, s2) + coef * entropy).mean()


_jax_vg = jax.jit(jax.value_and_grad(_jax_surrogate, argnums=(0, 1)))
_jax_ratio = jax.jit(lambda m, s, a, lo: jnp.exp(
    jmlp.gaussian_logprob(m, jnp.broadcast_to(s, m.shape), a).sum(-1)
    - lo.sum(-1)))


def _at_bounds(m, a, lp_old, rows, bound):
    """Puts the one-action rows ``rows`` exactly at ratio ``bound`` in both
    JAX's and torch's float32 arithmetic (log_std 0): ``a`` moved from ``m
    + 0.1`` in steps of 1e-3 and ``lp_old`` by float32 ulps until both
    ratios are the bound.  Returns the count placed."""
    n = len(rows)
    if n == 0:
        return 0
    steps = np.arange(-8, 9, dtype=np.int32)
    acts = m[rows, 0][:, None] + 0.1 + 1e-3 * np.arange(8, dtype=np.float32)
    acts = acts.astype(np.float32)                   # (n, 8)
    mm = np.repeat(m[rows, 0][:, None], 8, 1)
    lp = (-0.5 * (acts - mm) ** 2 - np.float32(0.91893853320467274))
    x0 = (lp - np.float32(np.log(bound))).astype(np.float32)
    cand = (x0[..., None].view(np.int32) + steps).view(np.float32)
    flat = (np.repeat(mm[..., None], 17, -1).reshape(-1, 1),
            np.zeros(1, np.float32),
            np.repeat(acts[..., None], 17, -1).reshape(-1, 1),
            cand.reshape(-1, 1))
    jr = np.asarray(_jax_ratio(*map(jnp.asarray, flat))).reshape(n, 8, 17)
    tr = K13._ratio(*map(torch.from_numpy, flat))[0].numpy().reshape(n, 8, 17)
    hit = (jr == np.float32(bound)) & (tr == np.float32(bound))
    placed = 0
    for i, r in enumerate(rows):
        idx = np.argwhere(hit[i])
        if len(idx):
            ai, ci = idx[0]
            a[r, 0], lp_old[r, 0] = acts[i, ai], cand[i, ai, ci]
            placed += 1
    return placed


def _k13_inputs(B, act, seed):
    """float32 rows: ratios over [exp(-0.6), exp(0.6)] with advantages of
    both signs, B/16 rows with a zero advantage, and for one action B/16
    rows at 1 + 0.2 and B/16 at 1 - 0.2 (log_std 0)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    m = rng.normal(0, 0.4, (B, act)).astype(f)
    ls = (rng.uniform(-0.5, 0.3, act) if act > 1 else np.zeros(act)).astype(f)
    a = (m + rng.normal(0, 0.5, (B, act))).astype(f)
    lp = (-0.5 * ((a - m) / np.exp(ls)) ** 2 - ls - 0.91893853320467274)
    lp_old = (lp - rng.uniform(-0.6, 0.6, (B, act)) / act).astype(f)
    adv = rng.normal(size=(B, 1)).astype(f)
    q = B // 16
    adv[B - 3 * q:B - 2 * q] = 0.0
    placed = {}
    if act == 1:
        for j, bound in enumerate((1.0 + CLIP, 1.0 - CLIP)):
            rows = np.arange(B - (2 - j) * q, B - (1 - j) * q)
            placed[bound] = _at_bounds(m, a, lp_old, rows, bound)
    return m, ls, a, lp_old, adv, placed


def _k13_rows(m, ls, a, lp_old, adv, coef):
    """The kernel's per-row terms in float32: the loss term ``min(s1, s2)
    + coef entropy`` (B, 1) and ``g_log_std``'s ``g_S (z^2 - 1) + gt coef``
    (B, A) at cotangent 1, and ``g_mean`` (B, A), as the plain twins."""
    ratio, lsb = K13._ratio(m, ls, a, lp_old)
    entropy = torch.sum(gaussian_entropy(lsb), dim=-1, keepdim=True)
    s1 = ratio * adv
    s2 = torch.clamp(ratio, 1.0 - CLIP, 1.0 + CLIP) * adv
    term = torch.minimum(s1, s2) + coef * entropy
    g_mean, _ = K13.ppo_loss_backward_plain(torch.tensor(1.0), m, ls, a,
                                            lp_old, adv, coef, CLIP)
    lo, hi = 1.0 - CLIP, 1.0 + CLIP
    std = torch.exp(lsb)
    z = (a - m) / std
    m1 = torch.clamp(ratio, min=lo)
    gt = torch.tensor(-1.0) / m.shape[0]
    w1 = K13._tie(s1 < s2, s1 == s2).to(m.dtype)
    w2 = K13._tie(s2 < s1, s1 == s2).to(m.dtype)
    c_hi = K13._tie(m1 < hi, m1 == hi).to(m.dtype)
    c_lo = K13._tie(ratio > lo, ratio == lo).to(m.dtype)
    g_s = (gt * w1 * adv + gt * w2 * adv * c_hi * c_lo) * ratio
    return term, g_s * (z * z - 1.0) + gt * coef, g_mean


@pytest.mark.parametrize("B", (1, 127, 128, 129, 3723, 20000))
@pytest.mark.parametrize("act", (4, 1))
def test_k13_order_vs_jax(B, act):
    """The loss and ``g_log_std`` summed in K13's order for its plan, and
    the per-row ``g_mean``, vs ``jax.value_and_grad`` of the surrogate,
    float32, ties at both clip bounds and at zero advantages included."""
    m, ls, a, lp_old, adv, placed = _k13_inputs(B, act, seed=B + act)
    if act == 1 and B >= 16:
        assert all(v == B // 16 for v in placed.values()), placed
    coef = np.float32(0.0097)
    jl, (jgm, jgs) = _jax_vg(*map(jnp.asarray, (m, ls[None], a, lp_old, adv,
                                                 coef)))
    assert jnp.asarray(jl).dtype == jnp.float32
    tm, tls, ta, tlo, tadv = map(torch.from_numpy, (m, ls, a, lp_old, adv))
    term, gls_rows, g_mean = _k13_rows(tm, tls, ta, tlo, tadv,
                                       torch.tensor(coef))
    loss = -(k13_sums(term, B)[0] / B)
    g_log_std = k13_sums(gls_rows, B)
    _close(float(loss), float(jl), 2e-5, "loss")
    _close(g_log_std.numpy(), np.asarray(jgs)[0], 2e-5, "g_log_std")
    _close(g_mean.numpy(), np.asarray(jgm), 2e-5, "g_mean")
    # the twin's forward and backward, summed in torch's order, agree too
    _close(float(K13.ppo_loss_plain(tm, tls, ta, tlo, tadv,
                                    torch.tensor(coef), CLIP)),
           float(loss), 2e-5, "loss vs twin")
