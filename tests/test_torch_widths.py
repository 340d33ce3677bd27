"""The port at an actor and critic width past the defaults (actor (32, 8),
critic 128, the widest whose JAX blocks build in seconds here), held to
the JAX package on the CPU, and the host side of the run-time-width
kernels at every shape ``chip_smoke.py``'s phase 26 checks on the card.

On the CPU every wrapper runs its plain twin, so the comparisons with JAX
hold the twins (width-generic code) and ``convert.py`` at these widths:
an ``EMLPBlock`` forward and VJP, each actor head, K7's twin on the padded
stack, the MLP PPO actor at 64 and 256 units and the parameter converters
(one TD3 update and one PPO minibatch step are
``test_torch_widths_td3.py`` and ``test_torch_widths_ppo.py``).  Tolerances: float64 1e-9 relative to
max(1, max |ref|) (1e-12 for the structured networks, as the default-width
tests); float32 2e-5 relative to max(1, max |ref|), the card's K3/K4
tolerance (only the summation order of a dot product differs).

The run-time kernels' host side: ``BlockSpec.rt_ints`` (the layout
``csrc/emlp_block.cu`` ``RtInts`` reads) decoded and run in float64 by
``rt_emulate`` against the twins; the atoms, block columns and staged
shared memory; the instances' ``forward_plan``/``backward_plan`` at the
wide shapes; the acting kernel's ``bilinear_plan``, image and
``any_plan``; K7's geometry; the MLP PPO actor's rows a block.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from gym_rotor_tpu.algos import regularizers as jreg
from gym_rotor_tpu.models import mlp as jmlp
from gym_rotor_tpu.models.emlp import nn as jnn
from gym_rotor_tpu.models.emlp import zoo as jzoo
from gym_rotor_tpu.utils.config import Config as JConfig
from gym_rotor_tpu_torch import convert
from gym_rotor_tpu_torch.algos import ppo as tppo
from gym_rotor_tpu_torch.algos import regularizers as treg
from gym_rotor_tpu_torch.algos import sac as tsac
from gym_rotor_tpu_torch.algos import td3 as ttd3
from gym_rotor_tpu_torch.kernels import emlp_actor as KA
from gym_rotor_tpu_torch.kernels import emlp_block as KB
from gym_rotor_tpu_torch.kernels import mlp_ppo_actor as KM
from gym_rotor_tpu_torch.kernels import spectral as KS
from gym_rotor_tpu_torch.models import mlp as tmlp
from gym_rotor_tpu_torch.models.emlp import nn as tnn
from gym_rotor_tpu_torch.models.emlp import reps as treps
from gym_rotor_tpu_torch.models.emlp import zoo as tzoo
from gym_rotor_tpu_torch.utils.config import Config as TConfig
from test_torch_td3 import _np_tree, _to64
from torch_jax_fixtures import jax_rho_memo  # noqa: F401

torch.set_num_threads(1)
WIDE = dict(actor_hidden_dim=(32, 8), critic_hidden_dim=128)
SMS = 132                   # an H100's SMs, which set the block columns
# phase 26's widths (actor_hidden_dim, critic_hidden_dim) and rows
PHASE_WIDTHS = (((8, 4), 8), ((32, 8), 128), ((64, 16), 256))
PHASE_ROWS = (1, 31, 32, 33, 256, 3723, 4096, 409600)
WIDE_CRITIC, WIDE_ACTOR = 512, (128, 32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, ref, rel, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref))) if got.size else 0.0
    tol = rel * max(1.0, float(np.max(np.abs(ref))) if ref.size else 0.0)
    assert err <= tol, f"{what}: max err {err:.3e} > {tol:.3e}"


def _cfgs(**kw):
    return JConfig(**WIDE, **kw), TConfig(**WIDE, **kw)


# ---------------------------------------------------------------------------
# The twins against JAX at (32, 8) / 128
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def flax_block():
    """Agent 0's critic hidden block at critic 128, (128, 144, 128), and
    seeded float64 params (the flax module's equivariant basis is built
    once for the module)."""
    jcfg, tcfg = _cfgs()
    jhid = jzoo.critic_reps(jcfg, "MODUL", 0, "DTDE")[1]
    thid = tzoo.critic_reps(tcfg, "MODUL", 0, "DTDE")[1]
    blk = jnn.EMLPBlock(jhid, jhid)
    params = _to64(blk.init(jax.random.PRNGKey(3), jnp.zeros((1, jhid.size))))
    return blk, params, thid


@pytest.mark.parametrize("dtype", ("float64", "float32"))
def test_block_matches_flax_at_width(flax_block, dtype):
    """``block_apply`` (the K3/K4 twins under autograd) vs flax's
    ``EMLPBlock`` at (128, 144, 128): h and ``jax.vjp`` with respect to x,
    kernel, bias and bi_params."""
    blk, params, thid = flax_block
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "float64" else \
        (jnp.float32, torch.float32)
    rel = 1e-9 if dtype == "float64" else 2e-5
    params = jax.tree.map(lambda a: a.astype(jdt), params)
    rng = np.random.default_rng(5)
    x = rng.normal(0, 0.7, (40, thid.size))
    g_out = rng.normal(size=(40, thid.size))
    h, vjp = jax.vjp(lambda p, xx: blk.apply(p, xx), params,
                     jnp.asarray(x, jdt))
    gp, gx = vjp(jnp.asarray(g_out, jdt))
    tblk = tnn.EMLPBlock(thid, thid, device="cpu", dtype=tdt)
    p = params["params"]
    leaves = {n: _t(a).requires_grad_(True) for n, a in (
        ("kernel", p["linear"]["kernel"]), ("bias", p["linear"]["bias"]),
        ("bi_params", p["bilinear"]["bi_params"]))}
    xt = _t(x).to(tdt).requires_grad_(True)
    W, b = tnn.project_linear(thid, tnn.gated(thid), leaves["kernel"],
                              leaves["bias"])
    v = tnn.bilinear_sparse(tblk.bilinear.rep, leaves["bi_params"])[3]
    spec = KB.block_spec(tblk, "cpu")
    assert spec.dims == (128, 144, 128) and spec.dims not in KB.INSTANCES
    ht = KB.block_apply(spec, xt, W, b, v)
    ht.backward(_t(g_out).to(tdt))
    _close(_np(ht), h, rel, "h")
    _close(_np(xt.grad), gx, rel, "grad x")
    for name, ref in (("kernel", gp["params"]["linear"]["kernel"]),
                      ("bias", gp["params"]["linear"]["bias"]),
                      ("bi_params", gp["params"]["bilinear"]["bi_params"])):
        _close(_np(leaves[name].grad), ref, rel, f"grad {name}")


HEADS = ("tanh", "gauss", "ppo")


@pytest.mark.parametrize("agent", (0, 1))
@pytest.mark.parametrize("head", HEADS)
def test_actor_heads_match_flax_at_width(head, agent):
    """Each head's plain twin (``emlp_actor_plain``, ``sac_actor_plain``,
    ``ppo_actor_plain``; what the acting kernels run on the CPU) at actor
    (32, 8), with the flax actor's params carried by ``convert``, vs the
    flax actor and the JAX acting arithmetic (``sac_sample_with_noise``;
    ``ppo.py:107-116``): float64, 1e-12; the action width and the
    acting kernel's dims."""
    jcfg, tcfg = _cfgs()
    models = {"tanh": jzoo.td3_models, "gauss": jzoo.sac_models,
              "ppo": jzoo.ppo_models}[head](jcfg, agent)
    obs_dim, act = jcfg.obs_dim_n[agent], jcfg.action_dim_n[agent]
    params = _to64(models.actor_def.init(jax.random.PRNGKey(11 + agent),
                                         jnp.zeros((1, obs_dim))))
    if head == "ppo":
        params["params"]["log_std"] = jnp.linspace(-0.6, 0.5, act)[None]
    rng = np.random.default_rng(agent)
    obs = rng.normal(0, 0.6, (24, obs_dim))
    noise = rng.normal(size=(24, act))
    reps = tzoo.actor_reps(tcfg, "MODUL", agent)
    if head == "tanh":
        actor = tzoo.EMLPActorDet(*reps, device="cpu", dtype=torch.float64)
        actor.load_state_dict(convert.actor_params_from_jax(
            _np_tree(params), tcfg, agent))
        want = [models.actor_def.apply(params, jnp.asarray(obs))]
        got = [KA.emlp_actor_plain(actor, _t(obs))]
    elif head == "gauss":
        actor = tzoo.EMLPActorSAC(*reps, act, device="cpu",
                                  dtype=torch.float64)
        actor.load_state_dict(convert.sac_actor_params_from_jax(
            _np_tree(params), tcfg, agent))
        mean, log_std = models.actor_def.apply(params, jnp.asarray(obs))
        want = [jmlp.sac_sample_with_noise(mean, log_std,
                                           jnp.asarray(noise))[0],
                jnp.tanh(mean)]
        got = [KA.sac_actor_plain(actor, _t(obs), _t(noise)),
               KA.sac_actor_plain(actor, _t(obs))]
    else:
        actor = tzoo.EMLPActorPPO(*reps, act, device="cpu",
                                  dtype=torch.float64)
        actor.load_state_dict(convert.ppo_actor_params_from_jax(
            _np_tree(params), tcfg, agent))
        mean, log_std = models.actor_def.apply(params, jnp.asarray(obs))
        a = jnp.clip(mean + jnp.exp(log_std) * jnp.asarray(noise), -1.0, 1.0)
        want = [a, jmlp.gaussian_logprob(mean, log_std, a),
                jnp.clip(mean, -1.0, 1.0)]
        got = [*KA.ppo_actor_plain(actor, _t(obs), _t(noise)),
               KA.ppo_actor_plain(actor, _t(obs))[0]]
    for k, (g, w) in enumerate(zip(got, want)):
        _close(_np(g), w, 1e-12, f"{head} output {k}")
    dims = KA.actor_dims(actor)
    assert dims[3] == act and dims not in KA.INSTANCES[KA.HEAD_TANH]


def test_spectral_twin_matches_jax_at_width():
    """``spectral_norm_regularization`` (K7's twin on the zero-padded
    stack) vs JAX's on agent 1's critic weights at critic 128 (the stack
    (3, 255, 128)), value and gradient, the start vectors drawn as JAX
    draws them, float64."""
    agent = ttd3.TD3Agent(_cfgs()[1], 1, "cpu", torch.float64)
    shapes = [tuple(s) for s in
              (w.shape for w in tnn.spectral_weights(agent.critic_layout.views(
                  torch.zeros(agent.critic_layout.size,
                              dtype=torch.float64)))[0])]
    rng = np.random.default_rng(9)
    ws = [rng.normal(0, 0.2, s) for s in shapes]
    key = jax.random.PRNGKey(13)
    val, gw = jax.value_and_grad(
        lambda w: jreg.spectral_norm_regularization(w, key))(
            [jnp.asarray(w) for w in ws])
    starts = [_t(jax.random.normal(jax.random.fold_in(key, i), (s[1],),
                                   jnp.float64)) for i, s in enumerate(shapes)]
    tw = [_t(w).requires_grad_(True) for w in ws]
    tval = treg.spectral_norm_regularization(tw, starts)
    tval.backward()
    _close(float(tval.detach()), float(val), 1e-9, "value")
    for a, b in zip(tw, gw):
        _close(_np(a.grad), b, 1e-9, "grad")
    Ws, _ = treg.stack_padded(tw, starts)
    assert tuple(Ws.shape) == (len(shapes), 255, 128)
    assert KS.instance(255, 128) is None


@pytest.mark.parametrize("hidden", (64, 256))
def test_mlp_ppo_actor_matches_flax(hidden):
    """``mlp_ppo_actor_plain`` (the fused MLP PPO actor's twin) at 64 and
    256 hidden units vs flax's ``ActorPPO`` and the acting arithmetic of
    ``ppo.py:107-116``, float64, 1e-12, train and eval modes."""
    mod = jmlp.ActorPPO(hidden_dim=hidden, action_dim=4)
    params = _to64(mod.init(jax.random.PRNGKey(hidden), jnp.zeros((1, 15))))
    params["params"]["log_std"] = jnp.asarray([[-0.5, 0.0, 0.3, 0.6]])
    jcfg, tcfg = JConfig(use_equiv=False, actor_hidden_dim=(hidden, 16)), \
        TConfig(use_equiv=False, actor_hidden_dim=(hidden, 16))
    actor = tmlp.ActorPPO(15, hidden, 4, device="cpu", dtype=torch.float64)
    actor.load_state_dict(convert.ppo_actor_params_from_jax(
        _np_tree(params), tcfg, 0))
    rng = np.random.default_rng(hidden)
    obs, noise = rng.normal(0, 0.6, (33, 15)), rng.normal(size=(33, 4))
    mean, log_std = mod.apply(params, jnp.asarray(obs))
    a = jnp.clip(mean + jnp.exp(log_std) * jnp.asarray(noise), -1.0, 1.0)
    ta, tlp = KM.mlp_ppo_actor_plain(actor, _t(obs), _t(noise))
    ea, elp = KM.mlp_ppo_actor_plain(actor, _t(obs))
    _close(_np(ta), a, 1e-12, "action")
    _close(_np(tlp), jmlp.gaussian_logprob(mean, log_std, a), 1e-12, "logp")
    _close(_np(ea), jnp.clip(mean, -1.0, 1.0), 1e-12, "eval action")
    assert not elp.any()
    assert KM.actor_dims(actor) not in KM.INSTANCES
    assert jcfg.actor_hidden_dim[0] == hidden


@pytest.fixture(scope="module")
def jax_states():
    """Agent 0's TD3 and SAC states from JAX at (32, 8) / 128 (float64)."""
    from gym_rotor_tpu.algos import sac as jsac
    from gym_rotor_tpu.algos import td3 as jtd3
    from gym_rotor_tpu.models import zoo as jmodels
    jcfg, _ = _cfgs()
    td3 = jtd3.TD3Agent(jcfg, 0, jmodels.td3_models(jcfg, 0))
    sac = jsac.SACAgent(jcfg, 0, jmodels.sac_models(jcfg, 0))
    return (_to64(td3.init(jax.random.PRNGKey(1))),
            _to64(sac.init(jax.random.PRNGKey(2))))


@pytest.mark.parametrize("which", ("td3", "sac"))
def test_convert_states_at_width(jax_states, which):
    """``td3_state_from_jax``/``sac_state_from_jax`` at (32, 8) / 128:
    every flat vector is ``ravel_pytree`` of its JAX tree, bit for bit;
    ``flat_to_jax`` and the structured converters carry the actor and
    critic trees back and forth; the layouts are the networks'."""
    jst = jax_states[0 if which == "td3" else 1]
    _, tcfg = _cfgs()
    cls = ttd3.TD3Agent if which == "td3" else tsac.SACAgent
    agent = cls(tcfg, 0, "cpu", torch.float64)
    conv = convert.td3_state_from_jax if which == "td3" else \
        convert.sac_state_from_jax
    st = conv(_np_tree(jst), agent)
    for name in ("actor", "critic"):
        np.testing.assert_array_equal(
            _np(getattr(st, name)), np.asarray(ravel_pytree(getattr(jst,
                                                                    name))[0]))
        layout = getattr(agent, f"{name}_layout")
        back = convert.flat_to_jax(getattr(st, name), layout)
        np.testing.assert_array_equal(
            np.asarray(ravel_pytree(back)[0]),
            np.asarray(ravel_pytree(getattr(jst, name))[0]))
    to_sd = convert.actor_params_from_jax if which == "td3" else \
        convert.sac_actor_params_from_jax
    to_jax = convert.actor_params_to_jax if which == "td3" else \
        convert.sac_actor_params_to_jax
    sd = to_sd(_np_tree(jst.actor), tcfg, 0)
    agent.actor_net.load_state_dict(sd)
    np.testing.assert_array_equal(
        np.asarray(ravel_pytree(to_jax(sd, tcfg, 0))[0]),
        np.asarray(ravel_pytree(jst.actor)[0]))
    critic = tzoo.EMLPCriticTwin(*tzoo.critic_reps(tcfg, "MODUL", 0, "DTDE"),
                                 device="cpu", dtype=torch.float64)
    critic.load_state_dict(convert.critic_params_from_jax(
        _np_tree(jst.critic), tcfg, 0))
    assert KB.block_spec(critic.network1.blocks()[1], "cpu").dims == \
        (128, 144, 128)


def test_convert_v_critic_at_width():
    """``v_critic_params_from_jax`` and ``ppo_actor_params_from_jax`` at
    (32, 8) / 128: the port's PPO networks take the flax trees leaf for
    leaf, in ``ravel_pytree`` order."""
    jcfg, tcfg = _cfgs()
    defs = jzoo.ppo_models(jcfg, 0)
    obs = jnp.zeros((1, jcfg.obs_dim_n[0]))
    ap = defs.actor_def.init(jax.random.PRNGKey(3), obs)
    cp = defs.critic_def.init(jax.random.PRNGKey(4), obs)
    agent = tppo.PPOAgent(tcfg, 0, "cpu")
    for params, layout, conv in (
            (ap, agent.actor_layout, convert.ppo_actor_params_from_jax),
            (cp, agent.critic_layout, convert.v_critic_params_from_jax)):
        sd = conv(_np_tree(params), tcfg, 0)
        assert set(sd) == set(layout.names)
        np.testing.assert_array_equal(
            np.concatenate([_np(sd[n]).reshape(-1) for n in layout.names]),
            np.asarray(ravel_pytree(params)[0]))


# ---------------------------------------------------------------------------
# The run-time kernels' host side at phase 26's shapes
# ---------------------------------------------------------------------------
def _phase_specs():
    """Every block shape phase 26 runs through the run-time K3/K4 path:
    the TD3 critics', the actors' and the PPO V critics' at each width, and
    the critic-512 hidden blocks, as ``{dims: BlockSpec}`` on the CPU."""
    specs = {}
    for ah, ch in PHASE_WIDTHS:
        cfg = TConfig(actor_hidden_dim=ah, critic_hidden_dim=ch)
        for i in (0, 1):
            nets = (ttd3.TD3Agent(cfg, i, "cpu").critic_net.network1,
                    ttd3.TD3Agent(cfg, i, "cpu").actor_net.network,
                    tppo.PPOAgent(cfg.replace(rl_algo="PPO"), i,
                                  "cpu").critic_net.network)
            for net in nets:
                for blk in net.blocks():
                    spec = KB.block_spec(blk, "cpu")
                    specs[spec.dims] = spec
    cfg = TConfig(critic_hidden_dim=WIDE_CRITIC)
    for i in (0, 1):
        hid = tzoo.critic_reps(cfg, "MODUL", i, "DTDE")[1]
        spec = KB.BlockSpec(hid, hid, tnn.gated(hid), "cpu")
        specs[spec.dims] = spec
    return specs


@pytest.fixture(scope="module")
def phase_specs():
    return _phase_specs()


def test_phase_specs_include_the_wide_blocks(phase_specs):
    """The wide shapes: critic 256's and 512's hidden blocks, the V
    critics' first blocks at 256, and the (8, 4) / 8 critic blocks that no
    instance has (the CPU tests' training width)."""
    for dims in ((256, 288, 256), (256, 511, 256), (15, 288, 256),
                 (3, 511, 256), (512, 568, 512), (512, 1023, 512),
                 (19, 9, 8), (8, 9, 8), (4, 15, 8), (8, 15, 8)):
        assert dims in phase_specs, dims
    assert any(d not in KB.INSTANCES for d in phase_specs)


def _rt_decode(spec):
    """``BlockSpec.rt_ints`` split at the offsets ``rt_ints_of`` reads, with
    the sparse steps' entries (``rt_words`` as coordinates, and
    ``rt_segments``) and the host's atoms (``rt_atoms``)."""
    ints = spec.rt_ints()
    a = _np(ints).astype(np.int64)
    ng, nh, nnz = spec.ng, spec.nh, spec.nnz
    out = {}
    for name, n in (("gate", nh), ("rowptr", ng + 1), ("ej", nnz),
                    ("ei", nnz), ("eo", nnz), ("cl_e", 2 * nnz),
                    ("ginv_ptr", ng + 1), ("ginv_k", nh)):
        out[name], a = a[:n], a[n:]
    assert a.size == 0 and ints.dtype == torch.int32
    w = _np(spec.rt_words(1, False)).view(np.uint32).astype(np.int64)
    out["cl_o"], out["cl_p"] = w[nnz:] >> 16, w[nnz:] & 0xffff
    segs, n_seg = spec.rt_segments()
    segs = _np(segs).astype(np.int64)
    out["cl_ptr"] = segs[:n_seg + 1][segs[n_seg + 1:]]
    out["atoms"] = KB.rt_atoms(spec.gate, nh)
    return out


def rt_emulate(spec, x, W, b, v, g_h):
    """The run-time kernels' steps (``csrc/emlp_block.cu``, run-time
    widths) from the decoded index (``_rt_decode``), numpy float64: lin,
    then per atom
    the gate coordinate's pre and each output's pre and h; g_pre per
    coordinate, g_lin from the coordinate-major lists, g_x, and g_W, g_b,
    g_v as sums over rows."""
    ix = _rt_decode(spec)
    lin = x @ W.T + b
    pre = np.full_like(lin, np.nan)
    h = np.full((x.shape[0], spec.nh), np.nan)

    def pre_of(o):
        e = np.arange(ix["rowptr"][o], ix["rowptr"][o + 1])
        q = (v[e] * lin[:, ix["ej"][e]] * lin[:, ix["ei"][e]]).sum(1)
        return 0.1 * q + lin[:, o]
    for k0, k1, g in ix["atoms"]:
        if g >= 0:
            pre[:, g] = pre_of(g)
        for k in range(k0, k1):
            pre[:, k] = pre_of(k)
            h[:, k] = pre[:, k] / (1 + np.exp(-pre[:, g if g >= 0 else k]))
    gpre = np.zeros_like(pre)
    for c in range(spec.ng):
        if c < spec.nh:
            gpre[:, c] = g_h[:, c] / (1 + np.exp(-pre[:, ix["gate"][c]]))
        s = 1 / (1 + np.exp(-pre[:, c]))
        for k in ix["ginv_k"][ix["ginv_ptr"][c]:ix["ginv_ptr"][c + 1]]:
            gpre[:, c] += g_h[:, k] * pre[:, k] * s * (1 - s)
    glin = gpre.copy()
    for c in range(spec.ng):
        e = np.arange(ix["cl_ptr"][c], ix["cl_ptr"][c + 1])
        glin[:, c] += 0.1 * (v[ix["cl_e"][e]] * gpre[:, ix["cl_o"][e]]
                             * lin[:, ix["cl_p"][e]]).sum(1)
    g_v = (0.1 * gpre[:, ix["eo"]] * lin[:, ix["ej"]]
           * lin[:, ix["ei"]]).sum(0)
    return (h, lin.T, pre.T), (glin @ W, glin.T @ x, glin.sum(0), g_v)


@pytest.mark.parametrize("dims", ((19, 9, 8), (8, 15, 8), (4, 15, 8),
                                  (15, 36, 32), (3, 15, 8), (62, 71, 62)),
                         ids=str)
def test_rt_index_runs_the_block(phase_specs, dims):
    """The run-time path's index, decoded as its kernels read it and run
    in float64 (``rt_emulate``), gives the twins' forward (h, lin, pre)
    and backward (g_x, g_W, g_b, g_v) within 1e-12, at 33 rows."""
    spec = phase_specs.get(dims) or KB.block_spec(
        tnn.EMLPBlock(*_instance_reps(dims), device="cpu"), "cpu")
    rng = np.random.default_rng(sum(dims))
    x = rng.normal(size=(33, spec.nin))
    W = rng.normal(size=(spec.ng, spec.nin)) / np.sqrt(spec.nin)
    b, v = rng.normal(size=spec.ng) * 0.1, rng.normal(size=spec.nnz) * 0.3
    g_h = rng.normal(size=(33, spec.nh))
    fwd, bwd = rt_emulate(spec, x, W, b, v, g_h)
    tf = KB.emlp_block_plain(spec, *map(_t, (x, W, b, v)))
    tb = KB.emlp_block_backward_plain(spec, _t(g_h), _t(x), _t(W), _t(v),
                                      tf[1], tf[2], True)
    for name, got, ref in zip(("h", "lin", "pre", "g_x", "g_W", "g_b", "g_v"),
                              fwd + bwd, tf + tb):
        _close(got, _np(ref), 1e-12, name)


def _instance_reps(dims):
    """(rep_in, rep_out) of the flagship's (62, 71, 62) block."""
    assert dims == (62, 71, 62)
    hid = tzoo.critic_reps(TConfig(), "MODUL", 0, "DTDE")[1]
    return hid, hid


def test_rt_plans_cover_every_coordinate_once(phase_specs):
    """At every phase-26 shape: the atoms partition the coordinates (each
    output once, each gate coordinate with its run, the runs sharing it
    gated by it), the lists are ``coordinate_lists``, and at every row
    count the block columns of the gate and list steps cover their atoms
    or coordinates once (the gate step's columns, ``rt_plan("forward")``:
    whole atoms, their outputs and the gates those read; the list step's,
    ``rt_plan("backward")``: runs of coordinates, their lists' segments
    dealt to the warps); the staged steps fit a
    block's shared memory where the host stages them, and the dense steps'
    static tiles 48 KB (``tests/test_torch_rt_block.py`` decodes the plans
    further)."""
    k, t = 32, KB.RT_GEMM_TILE
    assert max(2 * 2 * k * (t + 1), 2 * (t * (k + 1) + k * (t + 1))) * 4 \
        <= 48 * 1024
    for dims, spec in sorted(phase_specs.items()):
        ix = _rt_decode(spec)
        seen = np.zeros(spec.ng, np.int64)
        for k0, k1, g in ix["atoms"]:
            assert k1 > k0
            seen[k0:k1] += 1
            if g >= 0:
                seen[g] += 1
                assert g >= spec.nh
                np.testing.assert_array_equal(spec.gate[k0:k1], g)
            else:
                assert k1 == k0 + 1 and spec.gate[k0] == k0
        np.testing.assert_array_equal(seen, 1)
        for name, ref in zip(("cl_ptr", "cl_e", "cl_o", "cl_p"), spec.lists):
            np.testing.assert_array_equal(ix[name], ref)
        for B in PHASE_ROWS:
            bp, cols, _, _, _ = spec.rt_plan("backward", B, SMS)
            bp = _np(bp).astype(np.int64)
            assert bp.shape == (cols, 6 + 2 * KB.RT_WARPS)
            cover = np.zeros(spec.ng, np.int64)
            for c0, c1 in bp[:, 2:4]:
                cover[c0:c1] += 1
            np.testing.assert_array_equal(cover, 1)
            rg, cols, _, _, _ = spec.rt_plan("forward", B, SMS)
            rg = _np(rg).astype(np.int64)[:, :4]
            assert rg.shape[1] == 4 and 1 <= len(rg) <= len(ix["atoms"])
            np.testing.assert_array_equal(rg[1:, 0], rg[:-1, 1])
            assert rg[0, 0] == 0 and rg[-1, 1] == spec.nh
            cover = np.zeros(spec.ng, np.int64)
            for k0, k1, q0, q1 in rg:
                assert k1 > k0
                cover[k0:k1] += 1
                cover[q0:q1] += 1
                g = spec.gate[k0:k1]
                assert np.all((g == np.arange(k0, k1))
                              | ((g >= q0) & (g < q1)))
            np.testing.assert_array_equal(cover, 1)
            for kind in ("forward", "backward"):
                _, _, rows, stage, segs = spec.rt_plan(kind, B, SMS)
                assert stage == (KB.rt_smem(dims, kind, 1) <= KB.SMEM_LIMIT)
                assert KB.rt_smem(dims, kind, rows if stage else 0, segs) \
                    <= KB.SMEM_LIMIT
                assert KB.rt_smem(dims, kind, 0) == KB.RT_RING_BYTES


@pytest.mark.parametrize("groups", (1, 8, 132))
def test_instance_plans_at_wide_shapes(phase_specs, groups):
    """The instances' plans made at the wide shapes still partition them
    (``forward_plan``: outputs in whole atoms with their gates;
    ``backward_plan``: coordinates, lists cut into in-order segments, each
    dealt once), and their shared memory past the limit is why these
    shapes take the run-time path."""
    for dims in ((256, 511, 256), (512, 1023, 512)):
        spec = phase_specs[dims]
        fp = KB.forward_plan(spec.gate, spec.rowptr, spec.nh, groups)
        assert sorted(fp.arrays[0]) == list(range(spec.ng))
        assert fp.hdr[-1, 1] == spec.nh and fp.hdr[-1, 3] == spec.ng
        bp = KB.backward_plan(spec.lists[0], spec.rowptr, groups)
        wb, seg, cs = bp.arrays
        assert sorted(seg[:, 0]) == list(range(cs[-1])) and wb[-1] == len(seg)
        ptr = spec.lists[0]
        by_slot = seg[np.argsort(seg[:, 0])]
        starts = by_slot[cs[:-1], 1]
        np.testing.assert_array_equal(starts, ptr[:-1])
        np.testing.assert_array_equal(by_slot[cs[1:] - 1, 2], ptr[1:])
        assert KB.forward_smem(dims, fp.meta) > KB.SMEM_LIMIT


def _phase_actors():
    """The acting kernel's actors phase 26 checks: each head at every
    phase width and at actor (128, 32), both agents."""
    out = []
    for ah in [w[0] for w in PHASE_WIDTHS] + [WIDE_ACTOR]:
        cfg = TConfig(actor_hidden_dim=ah, critic_hidden_dim=8)
        for i in (0, 1):
            reps = tzoo.actor_reps(cfg, "MODUL", i)
            act = cfg.action_dim_n[i]
            gen = torch.Generator().manual_seed(i)
            out += [(ah, i, KA.HEAD_TANH, tzoo.EMLPActorDet(
                        *reps, device="cpu", generator=gen)),
                    (ah, i, KA.HEAD_GAUSS, tzoo.EMLPActorSAC(
                        *reps, act, device="cpu", generator=gen)),
                    (ah, i, KA.HEAD_PPO, tzoo.EMLPActorPPO(
                        *reps, act, device="cpu", generator=gen))]
    return out


def test_actor_plans_and_images_at_phase_widths():
    """Per actor and head of phase 26: the warps' ``bilinear_plan`` holds
    every output once and every nonzero once in its output's order; the
    image's nonzero words decode (at ``ent_scale``) to their coordinates;
    the fold's ``mul`` is what the run-time kernel scales them by; and
    ``any_plan`` keeps what it stages within a block's shared memory."""
    for ah, i, head, actor in _phase_actors():
        f = KA.fold_actor(actor)
        nin, ng, nh, nact = dims = f["dims"]
        sc = KA.ent_scale(ng)
        assert sc == KA.PITCH and f["mul"] == KA.PITCH // sc
        for b, (_, blk) in enumerate(actor.named_blocks()):
            idx = tnn.bilinear_index(blk.bilinear.rep, "cpu")
            rowptr = idx["rowptr"].numpy().astype(np.int64)
            wptr, task, tptr, perm = f["plans"][b]
            assert sorted(task) == list(range(ng))
            assert wptr[-1] == ng and len(wptr) == KA.actor_warps(ng) + 1
            for m, o in enumerate(task):
                np.testing.assert_array_equal(
                    perm[tptr[m]:tptr[m + 1]],
                    np.arange(rowptr[o], rowptr[o + 1]))
            ent = _np(KA.section(f, f"ent{b}", 2 * len(perm), True))
            np.testing.assert_array_equal(ent[0::2] >> 16,
                                          idx["j"].numpy()[perm] * sc)
            np.testing.assert_array_equal(ent[0::2] & 0xFFFF,
                                          idx["i"].numpy()[perm] * sc)
        stage_image, tile_smem, smem = KA.any_plan(
            dims, f["layout"], f["slots"], KA.plan_words(f))
        tile = 4 * (nin + ng + nh + 2 * f["slots"]) * KA.PITCH \
            + 4 * KA.plan_words(f)
        assert smem <= KA.SMEM_LIMIT and tile_smem == (tile <= KA.SMEM_LIMIT)
        assert smem == (4 * f["layout"]["words"] if stage_image else 0) + \
            (tile if tile_smem else 0)


def _uncached_pair_basis(ao, ai):
    """``pair_basis`` as it was before its caches: every action and the
    null space made anew for each pair."""
    no, ni = ao.size, ai.size
    Io, Ii = np.eye(no), np.eye(ni)
    rows = []
    for G in [ao.G] + ([ai.G] if ai.G != ao.G else []):
        acts_o, acts_i = G == ao.G, G == ai.G
        for A in G.lie_algebra:
            dro = ao.drho(A) if acts_o else np.zeros((no, no))
            dri = ai.drho(A) if acts_i else np.zeros((ni, ni))
            rows.append(np.kron(dro, Ii) - np.kron(Io, dri.T))
        for h in G.discrete_generators:
            ro = ao.rho(h) if acts_o else Io
            ri = ai.rho(h) if acts_i else Ii
            rows.append(np.kron(ro, np.linalg.inv(ri).T) - np.eye(no * ni))
    C = np.concatenate(rows, axis=0) if rows else np.zeros((0, no * ni))
    if C.shape[0] == 0:
        return np.eye(no * ni)
    U, S, VH = np.linalg.svd(C, full_matrices=True)
    return VH[int((S > treps.NULLSPACE_TOL).sum()):].conj().T


def test_scalar_pair_basis_is_the_dense_one():
    """``pair_basis`` with its caches (actions once per atom type and
    group, the null space once per constraint matrix) is bit for bit the
    uncached basis: for the Mirror group's ranks (each rank its own type:
    critic 256's Mirror hidden rep has ranks 0 .. 255), across groups,
    for the scalars of SO2eR3 and Trivial, and for SO2eR3's vectors."""
    from gym_rotor_tpu_torch.models.emlp import groups as tg
    atoms = [treps.Atom(tg.Mirror(1), r) for r in range(0, 70, 3)] + [
        treps.Atom(tg.Trivial(1), 0), treps.Atom(tg.SO2eR3(), 0),
        treps.Atom(tg.SO2eR3(), 1), treps.Atom(tg.Trivial(3), 0),
        treps.Atom(tg.Mirror(1), 255)]
    for ao in atoms:
        for ai in atoms:
            fast = treps.pair_basis(ao, ai)
            ref = _uncached_pair_basis(ao, ai)
            assert fast.shape == ref.shape
            assert fast.tobytes() == ref.tobytes(), (ao, ai)
    hid = tzoo.critic_reps(TConfig(critic_hidden_dim=256), "MODUL", 1,
                           "DTDE")[1]
    Qw, Qb, mask, bmask = tnn.linear_projector(hid, tnn.gated(hid))
    assert mask.shape == (511, 256) and Qw.shape[1] == 0


def test_actor_coordinate_encoding_past_16_bits():
    """Past ng = 1986 the tile offsets overflow 16 bits: the image holds
    the coordinates (``ent_scale`` 1) and the run-time kernel multiplies
    them by the pitch (``mul``); past 65536 coordinates an error."""
    assert KA.ent_scale(1986) == KA.PITCH and KA.ent_scale(1987) == 1
    assert KA.ent_scale(1 << 16) == 1
    with pytest.raises(ValueError):
        KA.ent_scale((1 << 16) + 1)


def test_spectral_geometry_at_phase_widths():
    """Every stack the learners hand K7 at the phase widths, and critic
    512's: those past the instances' 128 x 128 take the run-time kernel,
    whose plan (16-block clusters where the card runs them all at once)
    gives each block a band of rows, every row in exactly one band, and
    stages the band beside the vectors within a block's shared memory."""
    stacks = set()
    for ah, ch in PHASE_WIDTHS + ((WIDE_ACTOR, WIDE_CRITIC),):
        cfg = TConfig(actor_hidden_dim=ah, critic_hidden_dim=ch)
        for cls in (ttd3.TD3Agent, tsac.SACAgent, tppo.PPOAgent):
            for i in (0, 1):
                a = cls(cfg.replace(rl_algo=cls.__name__[:-5]), i, "cpu")
                for layout in (a.critic_layout, a.actor_layout):
                    ws, _ = tnn.spectral_weights(layout.views(torch.zeros(
                        layout.size)))
                    stacks.add((len(ws), max(w.shape[0] for w in ws),
                                max(w.shape[1] for w in ws)))
    assert (6, 1023, 512) in stacks and (6, 568, 512) in stacks
    assert (6, 511, 256) in stacks and (3, 511, 256) in stacks
    for K, mo, mi in stacks:
        geo = KS.instance(mo, mi)
        assert (geo is None) == (mo > 128 or mi > 128)
        p = KS.any_plan(K, mo, mi)
        owner = np.concatenate([np.full(max(0, min(mo, (r + 1) * p.band)
                                                - r * p.band), r)
                                for r in range(p.cluster)])
        assert len(owner) == mo and np.all(np.diff(owner) >= 0)
        assert (p.cluster, p.staged) == (16, True)
        assert p.smem == 4 * (3 * (mi + 3 & ~3) + (p.band + 3 & ~3)
                              + p.band * (mi + 3 & ~3))
        assert p.smem <= KS.SMEM_LIMIT


def test_spectral_chunks_past_the_shared_memory():
    """Past what a block holds, the run-time K7 reads its band from global
    memory (only x, the partial slots and y staged), everything within the
    limit; a band that fits is staged."""
    for mo, mi in ((1023, 512), (1700, 512), (4095, 2048), (20000, 4000)):
        p = KS.any_plan(6, mo, mi)
        assert 1 <= p.band and p.band * p.cluster >= mo
        assert p.smem <= KS.SMEM_LIMIT
        assert p.staged == (KS.any_smem(mi, p.band, True) <= KS.SMEM_LIMIT)
        assert p.staged == (mo <= 1700)


@pytest.mark.parametrize("hidden", (16, 64, 256, 900, 3632, 3633))
def test_mlp_ppo_actor_rows_a_block(hidden):
    """The run-time MLP PPO actor keeps 8 rows' two hidden layers in
    shared memory up to 3632 units (one row past it); the default actors
    are instances, the slice's (15, 64, 4) and (3, 16, 1) are not."""
    rows = 8 if 2 * 8 * hidden * 4 <= KB.SMEM_LIMIT else 1
    assert rows == (8 if hidden <= 3632 else 1)
    assert 2 * rows * hidden * 4 <= KB.SMEM_LIMIT
    assert ((15, hidden, 4) in KM.INSTANCES) == (hidden == 16)
    assert (3, 16, 1) not in KM.INSTANCES
