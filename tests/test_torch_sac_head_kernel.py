"""PyTorch port vs the JAX package: K10 fused with SAC's heads
(``kernels/sac_sample.py``: the mean and clipped log-std heads on the
trunk's output, the squashed sample and its log-prob, forward and
backward) and the fused MLP SAC actor's acting forward
(``kernels/mlp_sac_actor.py``), through their plain twins, which are what
run on CPU tensors.  The CUDA kernels are held to the same twins by
chip_smoke.py on the card.

JAX's heads are ``EMLPActorSAC``'s (``gym_rotor_tpu/models/emlp/zoo.py:
184-189``: ``EquivLinear`` on the folded ``W_eff`` (act, H), i.e.
``project=False``: the fold is K5's, held to JAX in
``test_torch_emlp.py``; ``nn.Dense`` for the log-std; ``jnp.clip``) and
``ActorSAC``'s (``models/mlp.py:107-119``: two ``nn.Dense`` (H, act)),
then ``sac_sample_with_noise``; gradients by ``jax.vjp``.  Narrow widths
(the actors of ``test_torch_td3.NARROW``), numpy seeds.

Data: h, the heads' weights and biases are small multiples of powers of
two, so every dot product of the heads is exact in any order: both
libraries' heads give the same bits and what is compared is the sample and
its derivative, as in ``test_torch_sac.py``'s K10 test.  Rows of three
kinds: moderate (|x| < 2.5), saturated (|mean| >= 31, |x| >= 20), and per
case a log-std column exactly at the upper bound (2), exactly at the lower
(-20), past the upper, past the lower, or moderate.

Tolerances.  Forward: float64 1e-10 of the compared array's largest
entry, float32 4 ulp of it.  Gradients: 1e-10 (float64) or 1e-5 (float32)
of the largest entry, plus 8 ulp per element of the intermediate terms
``rounding_scales`` names (the two cancelling paths through ``z``, the
cotangent on the action near saturation), carried through ``|W|`` into
``g_h`` and through ``|h|`` into the weight gradients.

The clip's gradient at a tie.  The port's plain path is torch.clamp's: the
cotangent passes where ``LOG_SIG_MIN <= x <= LOG_SIG_MAX``, the bounds
included.  JAX's ``jnp.clip`` (``minimum(maximum(x, lo), hi)``) splits it
at a tie: 0.5.  The cases at the bounds hold the port to JAX with the
port's rule (a clip whose gradient passes at the bounds, otherwise JAX's
expression) and check that JAX's own rule gives exactly half the log-std
bias gradient there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from gym_rotor_tpu.models import mlp as jmlp
from gym_rotor_tpu.models.emlp import nn as jnn
from gym_rotor_tpu.models.emlp import zoo as jzoo
from gym_rotor_tpu_torch.algos import sac as tsac
from gym_rotor_tpu_torch.kernels import mlp_sac_actor as KMS
from gym_rotor_tpu_torch.kernels import sac_sample as K10
from gym_rotor_tpu_torch.models import mlp as tmlp
from test_torch_td3 import AGENTS, _cfgs, _np, _t

torch.set_num_threads(1)

LO, HI = jmlp.LOG_SIG_MIN, jmlp.LOG_SIG_MAX
CASES = ("moderate", "upper", "lower", "past_upper", "past_lower")


def _head_dims(family, agent_id):
    """(H, act) of the narrow SAC actor's heads."""
    _, tcfg = _cfgs(rl_algo="SAC", use_equiv=family == "emlp")
    lay = tsac.SACAgent(tcfg, agent_id, "cpu").actor_layout
    shapes = dict(zip(lay.names, lay.shapes))
    return shapes["log_std_linear.kernel" if family == "emlp"
                  else "log_std.kernel"]


def _head_inputs(H, act, dense, case, dtype, seed=0, R=64):
    """Dyadic heads and h; the last quarter of the rows saturated (h = 64
    e_0 with |W_m[0]| = 1/2); log-std column 0 per ``case``."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-4, 5, (R, H)) / 16.0
    wm = rng.integers(-8, 9, (H, act)) / 32.0          # (H, act) here
    wm[0] = np.where(rng.uniform(size=act) < 0.5, -0.5, 0.5)
    bm = rng.integers(-8, 9, act) / 32.0
    wl = rng.integers(-4, 5, (H, act)) / 32.0
    bl = rng.integers(-8, 9, act) / 32.0 - 1.0
    q = 3 * R // 4
    h[q:] = 0.0
    h[q:, 0] = 64.0
    noise = np.clip(rng.normal(size=(R, act)), -1.2, 1.2)
    if case in ("upper", "lower"):
        wl[:, 0] = 0.0
        bl[0] = HI if case == "upper" else LO
    elif case in ("past_upper", "past_lower"):
        wl[0, 0] = 0.0
        bl[0] = 24.0 if case == "past_upper" else -24.0
    if case in ("upper", "past_upper"):
        noise[:q, 0] *= 0.1                 # keeps |x| < 2.5 at std e^2
    g_a = rng.normal(size=(R, act))
    g_l = rng.normal(size=(R, 1))
    wm = wm if dense else wm.T.copy()
    return [a.astype(dtype) for a in (h, wm, bm, wl, bl, noise, g_a, g_l)]


def _jax_heads(family, agent_id, tie_pass):
    """JAX's head and sample as a function of (h, W_m, b_m, W_ls, b_ls)
    and the noise; with ``tie_pass`` the clip's gradient passes at the
    bounds (the port's rule)."""
    if family == "emlp":
        jcfg, _ = _cfgs(rl_algo="SAC")
        _, hidden, rep_out = jzoo.actor_reps(jcfg, "MODUL", agent_id)[:3]
        mean_mod = jnn.EquivLinear(hidden, rep_out, project=False)
    else:
        mean_mod = None

    def clip(x):
        if not tie_pass:
            return jnp.clip(x, LO, HI)
        return jnp.where((x >= LO) & (x <= HI), x,
                         jax.lax.stop_gradient(jnp.clip(x, LO, HI)))

    def f(h, wm, bm, wl, bl, noise):
        act = bm.shape[0]
        if mean_mod is not None:
            mean = mean_mod.apply({"params": {"kernel": wm, "bias": bm}}, h)
        else:
            mean = fnn.Dense(act).apply(
                {"params": {"kernel": wm, "bias": bm}}, h)
        pre = fnn.Dense(act).apply({"params": {"kernel": wl, "bias": bl}}, h)
        a, lp, _ = jmlp.sac_sample_with_noise(mean, clip(pre), noise)
        return a, lp
    return f


def _allowances(inp, dense, ulp):
    """Per-element allowances of (g_h, g_W_m, g_b_m, g_W_ls, g_b_ls): 8 ulp
    of ``rounding_scales`` carried through the heads."""
    h, wm, bm, wl, bl, noise, g_a, g_l = (_t(a) for a in inp)
    mean, log_std = K10.head_plain(h, wm, bm, wl, bl, dense)
    sm, ss = K10.rounding_scales(g_a, g_l, mean, log_std, noise)
    am, al = 8 * ulp * sm, 8 * ulp * ss
    w_m = wm.t() if dense else wm
    a_h = am @ w_m.abs() + al @ wl.abs().t()
    a_wm = h.abs().t() @ am
    return [a_h, a_wm if dense else a_wm.t(), am.sum(0),
            h.abs().t() @ al, al.sum(0)]


def _check(name, got, ref, rel, extra=0.0):
    got = _np(got).astype(np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = np.abs(got - ref)
    tol = rel * max(np.abs(ref).max(), 1e-30) + np.asarray(extra)
    assert (err <= tol).all(), (name, err.max(), np.abs(ref).max())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("agent_id", AGENTS)
@pytest.mark.parametrize("family", ["emlp", "mlp"])
def test_sac_head_twin_matches_jax(family, agent_id, dtype, case):
    """The fused head's twin under autograd (the torch chain on CPU
    tensors, ``sac_head_sample``) vs JAX's heads, clip and
    ``sac_sample_with_noise`` with ``jax.vjp``: the action, the log-prob
    and the gradients with respect to h and the four head parameters."""
    dense = family == "mlp"
    H, act = _head_dims(family, agent_id)
    inp = _head_inputs(H, act, dense, case, dtype, seed=agent_id)
    tie = case in ("upper", "lower")
    f = _jax_heads(family, agent_id, tie_pass=tie)
    jin = [jnp.asarray(a) for a in inp[:5]]
    noise = jnp.asarray(inp[5])
    (ja, jl), vjp = jax.vjp(lambda *p: f(*p, noise), *jin)
    jgrads = vjp((jnp.asarray(inp[6]), jnp.asarray(inp[7])))
    leaves = [_t(a).requires_grad_(True) for a in inp[:5]]
    ta, tl = K10.sac_head_sample(*leaves, _t(inp[5]), dense)
    tgrads = torch.autograd.grad((ta, tl), leaves,
                                 (_t(inp[6]), _t(inp[7])))
    ulp = float(np.finfo(dtype).eps)
    fwd, bwd = (1e-10, 1e-10) if dtype == "float64" else (4 * ulp, 1e-5)
    _check("action", ta, ja, fwd)
    _check("logp", tl, jl, fwd)
    names = ("g_h", "g_W_m", "g_b_m", "g_W_ls", "g_b_ls")
    for name, got, ref, extra in zip(names, tgrads, jgrads,
                                     _allowances(inp, dense, ulp)):
        _check(name, got, ref, bwd, _np(extra))
    q = 3 * inp[0].shape[0] // 4
    assert (np.abs(_np(ta)[q:]) == 1.0).all()          # saturated rows
    pre = _np(K10.head_pre(*(_t(a) for a in inp[:5]), dense)[1])
    if tie:
        assert (pre[:, 0] == (HI if case == "upper" else LO)).all()
        # JAX's own clip passes half the cotangent at a tie
        g_own = jax.vjp(lambda *p: _jax_heads(family, agent_id, False)(
            *p, noise), *jin)[1]((jnp.asarray(inp[6]),
                                  jnp.asarray(inp[7])))
        assert float(g_own[4][0]) == 0.5 * float(jgrads[4][0]) != 0.0
    elif case.startswith("past"):
        assert (np.abs(pre[:, 0]) > 2 * HI).all()
        assert float(tgrads[4][0]) == 0.0


@pytest.mark.parametrize("case", ["moderate", "upper", "lower", "past_upper"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("family", ["emlp", "mlp"])
def test_head_function_matches_the_chain(family, dtype, case):
    """The autograd function the card runs (``SACHeadFn``: the twins of the
    forward and backward launches, ``sac_head_backward_plain``'s ``M =
    [h | 1]^T G`` split by ``head_grads``) vs the torch chain's autograd:
    values bitwise, gradients within 1e-12 (float64) or 1e-5 (float32) of
    the largest entry; and ``sac_head_backward_plain``'s ``g_h`` and ``G``
    vs the chain's gradients of h and of the heads' outputs."""
    dense = family == "mlp"
    H, act = _head_dims(family, 0)
    inp = [_t(a, dtype) for a in _head_inputs(H, act, dense, case,
                                              "float64", seed=3)]
    h, wm, bm, wl, bl, noise, g_a, g_l = inp
    chain = [t.clone().requires_grad_(True) for t in inp[:5]]
    fused = [t.clone().requires_grad_(True) for t in inp[:5]]
    a1, l1 = K10.sac_head_sample(*chain, noise, dense)
    a2, l2 = K10.SACHeadFn.apply(*fused, noise, dense)
    assert torch.equal(a1, a2) and torch.equal(l1, l2)
    g1 = torch.autograd.grad((a1, l1), chain, (g_a, g_l))
    g2 = torch.autograd.grad((a2, l2), fused, (g_a, g_l))
    rel = 1e-12 if dtype == torch.float64 else 1e-5
    for x, y in zip(g2, g1):
        _check("grad", x, _np(y), rel)
    g_h, G, M = K10.sac_head_backward_plain(g_a, g_l, *inp[:5], noise, dense,
                                            with_G=True)
    _check("g_h", g_h, _np(g1[0]), rel)
    g_h2, none, M2 = K10.sac_head_backward_plain(g_a, g_l, *inp[:5], noise,
                                                 dense)
    assert none is None and torch.equal(g_h2, g_h) and torch.equal(M2, M)
    mean_pre = [t.clone().requires_grad_(True)
                for t in K10.head_pre(h, wm, bm, wl, bl, dense)]
    a3, l3 = K10.squashed_gaussian(
        mean_pre[0], torch.clamp(mean_pre[1], LO, HI), noise)
    gm, gp = torch.autograd.grad((a3, l3), mean_pre, (g_a, g_l))
    assert torch.equal(G, torch.cat([gm, gp], dim=1))
    assert M.shape == (H + 1, 2 * act)


@pytest.mark.parametrize("dims", [(15, 16, 4), (3, 4, 1), (23, 16, 4),
                                  (15, 256, 4), (3, 50, 1)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_mlp_sac_actor_twin_matches_flax(dims, dtype, mode):
    """The fused MLP SAC actor's twin (``ActorSAC.forward`` on CPU
    tensors, ``mlp_sac_actor_plain``) vs flax's ``ActorSAC`` with
    ``sac_sample_with_noise`` on the same noise (``tanh(mean)`` in eval),
    with the log-std head's bias pushed past its upper clip on one action:
    float64 within 1e-12, float32 within 4 ulp of the largest entry; the
    result written into a column slice, the other columns kept."""
    nin, nh, act = dims
    rng = np.random.default_rng(sum(dims))
    mod = jmlp.ActorSAC(nh, act)
    params = mod.init(jax.random.PRNGKey(sum(dims)), jnp.zeros((1, nin)))
    params = jax.tree.map(lambda a: np.array(a, dtype), params)
    params["params"]["log_std"]["bias"][0] = 25.0
    obs = rng.normal(0, 0.6, (40, nin)).astype(dtype)
    noise = rng.normal(size=(40, act)).astype(dtype)
    mean, log_std = mod.apply(params, jnp.asarray(obs))
    ref = (jmlp.sac_sample_with_noise(mean, log_std, jnp.asarray(noise))[0]
           if mode == "train" else jnp.tanh(mean))
    actor = tmlp.ActorSAC(nin, nh, act, device="cpu",
                          dtype=getattr(torch, dtype))
    actor.load_state_dict({f"{layer}.{k}": _t(v)
                           for layer, p in params["params"].items()
                           for k, v in p.items()})
    nz = _t(noise) if mode == "train" else None
    out = torch.full((40, act + 2), 7.0, dtype=getattr(torch, dtype))
    before = KMS.mlp_sac_actor.launches
    with torch.no_grad():
        got = actor(_t(obs), nz, out[:, 1:1 + act])
        plain = KMS.mlp_sac_actor_plain(actor, _t(obs), nz)
    assert torch.equal(got, plain) and (out[:, [0, -1]] == 7.0).all()
    rel = 1e-12 if dtype == "float64" else 4 * float(np.finfo(dtype).eps)
    _check("action", got, ref, rel)
    assert KMS.mlp_sac_actor.launches == before
