"""K10 fused with SAC's actor head: the mean and clipped log-std heads on the
trunk's last hidden activations, the squashed-Gaussian sample and its summed
log-prob, forward and backward, one launch each, under ``torch.autograd``.

Replaces ``gym_rotor_tpu/models/mlp.py:129`` ``sac_sample_with_noise`` with
the heads that feed it (``gym_rotor_tpu/models/emlp/zoo.py:169-190``
``EMLPActorSAC``'s ``network_head`` and clipped ``log_std_linear``;
``models/mlp.py:107-119`` ``ActorSAC``'s ``mean`` and clipped ``log_std``
Dense) and their autodiff in the SAC actor loss, which XLA fused on the TPU.
Kernel: ``csrc/sac_sample.cu`` (the per-row head, ``csrc/sac_head.cuh``, is
shared with the MLP SAC actor's acting kernel).  Plain twins:
``sac_head_plain`` (the port's torch chain: the two heads, the clamp and
``sac_sample_with_noise``) and ``sac_head_backward_plain`` (its derivative
written out as the kernel computes it), which are what run on CPU tensors.

The heads: ``mean = h W_m + b_m`` and ``log_std = clamp(h W_ls + b_ls,
LOG_SIG_MIN, LOG_SIG_MAX)``.  ``W_m`` is taken as stored: the EMLP head's
K5-folded ``W_eff`` (act, H) (``dense=False``), or the MLP's ``mean`` Dense
kernel (H, act) (``dense=True``); ``W_ls`` is a Dense kernel (H, act) in
both.  The clamp's gradient passes where ``LOG_SIG_MIN <= x <= LOG_SIG_MAX``,
the bounds included: torch.clamp's rule, which the port's plain path has
always used.  JAX's ``jnp.clip`` splits the cotangent there (0.5 at a tie);
``tests/test_torch_sac_head_kernel.py`` lands on both bounds and checks
both rules.

The sample's backward differentiates JAX's expression as written: ``z = (x
- m) / std`` reaches ``m`` and ``std`` both directly and through ``x = m +
std n``.  The two paths cancel in exact arithmetic (``g_m`` and ``g_std``
carry ``+-g_logp z / std``), and near saturation the cotangent on the action
is ``~2 g_logp / ((1 - a^2) + EPS)``, up to ~2e6 ``g_logp``: where ``std``
is tiny (``log_std`` at its lower clip) or ``a`` is +-1, any two
derivations (JAX's autodiff, this one, the kernel) round those large
intermediate terms differently.  Tests and ``chip_smoke.py`` allow a few
ulp of them per element (``rounding_scales``).  The heads' dot products are
the kernel's own, in k order, where the twin's are the BLAS's: the two
agree to float32 rounding of the heads (``head_scales``), not bitwise.

The backward launch gives ``g_h`` and the four weight and bias gradients
as one matrix ``M = [h | 1]^T G`` of ``G = [g_mean | g_log_std]`` (the
clip's mask applied; ``G`` itself is written out only for checks), summed
in the launch (each block its rows in row order, the blocks' partials by
the block that takes the last ticket, in block order:
``_ticket``, as K8's statistics in ``kernels/replay.py``), so a rerun
repeats its bits.

What bounds it on an H100: the bytes (~115 KB forward, ~168 KB backward at
the actor loss's 1024 rows of H = 16, 4 actions: 0.03 / 0.05 us); the
launch dominates.  A row on A lanes, one action a lane (``csrc/
sac_sample.cu``); any H (a head wider than 64 stages its rows of h in
chunks).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..models.mlp import EPS, LOG_SIG_MAX, LOG_SIG_MIN, sac_sample_with_noise
from .build import KernelSource, check

KERNEL = KernelSource("sac_sample", ["-fmad=false"])
WRAPPERS = {"sac_head": "sac_head_plain",
            "sac_head_backward": "sac_head_backward_plain"}
MAX_ACT = 4


def _lib():
    lib = KERNEL.load()
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        head = [P, I, I, P, P, I, I, P]     # W_m, its strides, b_m; W_ls ...
        lib.sac_head_fwd_launch.argtypes = [P, I, I, I] + head + [P, P, P, P]
        lib.sac_head_fwd_launch.restype = I
        lib.sac_head_bwd_launch.argtypes = [P, P, P, I, I, I] + head \
            + [P] * 7
        lib.sac_head_bwd_launch.restype = I
        lib.sac_head_blocks.argtypes = [I, I]
        lib.sac_head_blocks.restype = I
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# Plain twins (CPU tensors)
# ---------------------------------------------------------------------------
def sac_sample_plain(mean, log_std, noise):
    """The sample alone: ``(action, log_prob (..., 1))``."""
    action, logp, _ = sac_sample_with_noise(mean, log_std, noise)
    return action, logp


def sac_sample_backward_plain(g_action, g_logp, mean, log_std, noise):
    """``(g_mean, g_log_std)`` of ``sac_sample_plain`` for the cotangents
    ``g_action`` (..., act) and ``g_logp`` (..., 1)."""
    std = torch.exp(log_std)
    x = mean + std * noise
    a = torch.tanh(x)
    d = x - mean
    z = d / std
    one_m = 1.0 - a * a
    g_z = -g_logp * z
    g_d = g_z / std
    g_std_z = (-g_z * d) / (std * std)
    g_x = g_action * one_m
    g_x = g_x + g_logp * ((2.0 * a * one_m) / (one_m + EPS))
    g_x = g_x + g_d
    g_std = g_x * noise + g_std_z
    return g_x - g_d, std * g_std - g_logp


def rounding_scales(g_action, g_logp, mean, log_std, noise):
    """Per element, the size of the intermediate terms that ``g_mean`` and
    ``g_log_std`` are sums of: ``|g_logp z / std|`` (the two cancelling
    paths), ``|g_action|`` and the cotangent on the action ``2 |g_logp| /
    ((1 - a^2) + EPS)``; for ``g_log_std`` scaled through ``std n``, plus
    ``|g_logp| (z^2 + 1)``.  Two evaluation orders of the derivative may
    differ by a few ulp of these."""
    std = torch.exp(log_std)
    x = mean + std * noise
    a = torch.tanh(x)
    z = (x - mean) / std
    s = ((g_logp * z / std).abs() + g_action.abs()
         + 2.0 * g_logp.abs() / ((1.0 - a * a) + EPS))
    return s, std * noise.abs() * s + g_logp.abs() * (z * z + 1.0)


def head_pre(h, wm, bm, wl, bl, dense: bool):
    """``(mean, log_std before the clamp)`` as the port's torch chain
    computes them: ``F.linear`` on the MLP's Dense kernels (``dense``), or
    ``h @ W_eff.T + b`` and ``h @ W_ls + b_ls`` on the EMLP head."""
    if dense:
        return F.linear(h, wm.t(), bm), F.linear(h, wl.t(), bl)
    return h @ wm.T + bm, h @ wl + bl


def head_plain(h, wm, bm, wl, bl, dense: bool):
    """``(mean, log_std)``: the heads, ``log_std`` clamped."""
    mean, pre = head_pre(h, wm, bm, wl, bl, dense)
    return mean, torch.clamp(pre, LOG_SIG_MIN, LOG_SIG_MAX)


def sac_head_plain(h, wm, bm, wl, bl, noise, dense: bool):
    """``(action (R, act), log_prob (R, 1))`` of the heads on ``h`` and the
    N(0, 1) draw ``noise``."""
    return sac_sample_plain(*head_plain(h, wm, bm, wl, bl, dense), noise)


def sac_head_backward_plain(g_action, g_logp, h, wm, bm, wl, bl, noise,
                            dense: bool, with_G: bool = False):
    """``(g_h (R, H), G (R, 2 act), M (H + 1, 2 act))`` for the cotangents
    ``g_action`` and ``g_logp``: ``G = [g_mean | g_log_std]`` with
    ``g_log_std`` zero where the clamp held its input (None unless
    ``with_G``: for checks), ``g_h = g_mean W_m^T + g_log_std W_ls^T``
    (``W_m`` as (act, H)) and ``M = [h | 1]^T G``, the heads' weight and
    bias gradients (``head_grads``)."""
    mean, pre = head_pre(h, wm, bm, wl, bl, dense)
    log_std = torch.clamp(pre, LOG_SIG_MIN, LOG_SIG_MAX)
    g_mean, g_ls = sac_sample_backward_plain(g_action, g_logp, mean, log_std,
                                             noise)
    g_ls = torch.where((pre >= LOG_SIG_MIN) & (pre <= LOG_SIG_MAX), g_ls,
                       torch.zeros((), dtype=g_ls.dtype, device=g_ls.device))
    w_m = wm.t() if dense else wm
    g_h = g_mean @ w_m + g_ls @ wl.t()
    G = torch.cat([g_mean, g_ls], dim=1)
    xa = torch.cat([h, torch.ones_like(h[:, :1])], dim=1)
    return g_h, G if with_G else None, xa.t() @ G


def head_in_order(h, wm, bm, wl, bl, dense: bool):
    """``(mean, log_std before the clamp)`` in the kernel's order: each dot
    product ``h_0 w_0``, then ``+ h_k w_k`` for k = 1, 2, ..., then the
    bias, one rounding an operation (bitwise the kernel's on float32 CUDA
    tensors: it is built with -fmad=false).  For checks: the kernel's
    sample is held to ``sac_sample_plain`` on these."""
    w_m = wm if dense else wm.t()
    m, pre = h[:, :1] * w_m[0], h[:, :1] * wl[0]
    for k in range(1, h.shape[1]):
        m = m + h[:, k:k + 1] * w_m[k]
        pre = pre + h[:, k:k + 1] * wl[k]
    return m + bm, pre + bl


def head_scales(h, wm, bm, wl, bl, dense: bool):
    """Per row and action, ``(sum_k |h_k W_m[k]| + |b_m|, sum_k |h_k
    W_ls[k]| + |b_ls|)``: the size of the heads' dot products, to which two
    summation orders' results are within ``H`` ulp."""
    w_m = wm if dense else wm.t()
    return h.abs() @ w_m.abs() + bm.abs(), h.abs() @ wl.abs() + bl.abs()


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors)
# ---------------------------------------------------------------------------
def _check(name, t, shape, device, contiguous=True):
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) \
            or (contiguous and not t.is_contiguous()):
        raise ValueError(f"sac_head: {name} must be a "
                         f"{'contiguous ' if contiguous else ''}float32 "
                         f"{tuple(shape)} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


_TICKETS = {}


def _ticket(device) -> torch.Tensor:
    """The device's ticket counter for the backward's last-block sum: one
    zeroed int32, left zeroed by every launch."""
    key = str(device)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _TICKETS[key]


def _args(h, wm, bm, wl, bl, noise, dense):
    """Check the operands; returns ``(R, H, act, head arguments)``."""
    if h.dim() != 2 or h.shape[0] == 0 or h.shape[1] == 0:
        raise ValueError(f"sac_head: h must be (R, H) with R, H > 0, got "
                         f"{tuple(h.shape)}")
    R, H = int(h.shape[0]), int(h.shape[1])
    act = int(bm.shape[0]) if bm.dim() == 1 else -1
    if not 1 <= act <= MAX_ACT:
        raise ValueError(f"sac_head: at most {MAX_ACT} actions, got "
                         f"{tuple(bm.shape)}")
    dev = h.device
    _check("h", h, (R, H), dev)
    _check("noise", noise, (R, act), dev)
    _check("W_m", wm, (H, act) if dense else (act, H), dev, False)
    _check("W_ls", wl, (H, act), dev, False)
    for name, b in (("b_m", bm), ("b_ls", bl)):
        _check(name, b, (act,), dev)
    sk, sa = wm.stride() if dense else wm.stride()[::-1]
    return R, H, act, [wm.data_ptr(), sk, sa, bm.data_ptr(), wl.data_ptr(),
                       wl.stride(0), wl.stride(1), bl.data_ptr()]


def sac_head(h, wm, bm, wl, bl, noise, dense: bool):
    """Forward: ``(action (R, act), log_prob (R, 1))``.  CPU tensors ->
    ``sac_head_plain``; CUDA tensors -> one kernel launch (float32, act <=
    4), or an error."""
    if not h.is_cuda:
        return sac_head_plain(h, wm, bm, wl, bl, noise, dense)
    R, H, act, head = _args(h, wm, bm, wl, bl, noise, dense)
    dev = h.device
    action = torch.empty(R, act, dtype=torch.float32, device=dev)
    logp = torch.empty(R, 1, dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.sac_head_fwd_launch(
        h.data_ptr(), R, H, act, *head, noise.data_ptr(), action.data_ptr(),
        logp.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "sac_head forward")
    sac_head.launches += 1
    return action, logp


sac_head.launches = 0


def sac_head_backward(g_action, g_logp, h, wm, bm, wl, bl, noise,
                      dense: bool, with_G: bool = False):
    """Backward: ``(g_h, G, M)`` as ``sac_head_backward_plain`` (``G``
    written out only ``with_G``).  CPU tensors ->
    ``sac_head_backward_plain``; CUDA tensors -> one kernel launch (the
    weight gradients summed in it), or an error."""
    if not h.is_cuda:
        return sac_head_backward_plain(g_action, g_logp, h, wm, bm, wl, bl,
                                       noise, dense, with_G)
    R, H, act, head = _args(h, wm, bm, wl, bl, noise, dense)
    dev = h.device
    _check("g_action", g_action, (R, act), dev)
    _check("g_logp", g_logp, (R, 1), dev)
    f32 = torch.float32
    g_h = torch.empty(R, H, dtype=f32, device=dev)
    G = torch.empty(R, 2 * act, dtype=f32, device=dev) if with_G else None
    M = torch.empty(H + 1, 2 * act, dtype=f32, device=dev)
    lib = _lib()
    blocks = lib.sac_head_blocks(R, act)
    partial = (torch.empty(blocks * M.numel(), dtype=f32, device=dev)
               if blocks > 1 else None)
    err = lib.sac_head_bwd_launch(
        g_action.data_ptr(), g_logp.data_ptr(), h.data_ptr(), R, H, act,
        *head, noise.data_ptr(), g_h.data_ptr(),
        None if G is None else G.data_ptr(), M.data_ptr(),
        None if partial is None else partial.data_ptr(),
        _ticket(dev).data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, lib, "sac_head backward")
    sac_head_backward.launches += 1
    return g_h, G, M


sac_head_backward.launches = 0


def head_grads(M, H: int, act: int, dense: bool):
    """``(g_W_m, g_b_m, g_W_ls, g_b_ls)``, views of the backward's ``M =
    [h | 1]^T G``: ``g_W_m`` in ``W_m``'s layout ((H, act) when ``dense``,
    else (act, H))."""
    g_wm = M[:H, :act] if dense else M[:H, :act].t()
    return g_wm, M[H, :act], M[:H, act:], M[H, act:]


class SACHeadFn(torch.autograd.Function):
    """``(action, log_prob) = head + sample(h; W_m, b_m, W_ls, b_ls,
    noise)`` with the fused kernel's forward and backward; ``noise`` is a
    constant draw."""

    @staticmethod
    def forward(ctx, h, wm, bm, wl, bl, noise, dense):
        ctx.dense = dense
        ctx.save_for_backward(h, wm, bm, wl, bl, noise)
        return sac_head(h, wm, bm, wl, bl, noise, dense)

    @staticmethod
    def backward(ctx, g_action, g_logp):
        h, wm, bm, wl, bl, noise = ctx.saved_tensors
        g_h, _, M = sac_head_backward(g_action.contiguous(),
                                      g_logp.contiguous(), h, wm, bm, wl,
                                      bl, noise, ctx.dense)
        need = ctx.needs_input_grad
        grads = (head_grads(M, h.shape[1], bm.shape[0], ctx.dense)
                 if any(need[1:5]) else (None,) * 4)
        return (g_h if need[0] else None, *grads, None, None)


class SquashedGaussianFn(torch.autograd.Function):
    """``(action, log_prob) = sample(mean, log_std; noise)`` with the plain
    sample and its hand backward: the CPU chain's last step."""

    @staticmethod
    def forward(ctx, mean, log_std, noise):
        ctx.save_for_backward(mean, log_std, noise)
        return sac_sample_plain(mean, log_std, noise)

    @staticmethod
    def backward(ctx, g_action, g_logp):
        mean, log_std, noise = ctx.saved_tensors
        g_mean, g_log_std = sac_sample_backward_plain(
            g_action.contiguous(), g_logp.contiguous(), mean, log_std, noise)
        return g_mean, g_log_std, None


def squashed_gaussian(mean, log_std, noise):
    """The sample and its summed log-prob ``(action (B, act), log_prob (B,
    1))`` under autograd, from given ``(mean, log_std)``: the plain sample
    and its hand backward."""
    return SquashedGaussianFn.apply(mean.contiguous(), log_std.contiguous(),
                                    noise.contiguous())


def sac_head_sample(h, wm, bm, wl, bl, noise, dense: bool):
    """SAC's head and sample on the trunk's output ``h`` under autograd:
    ``(action (R, act), log_prob (R, 1))``.  CUDA tensors -> the fused
    kernel (one forward launch; one backward launch when differentiated;
    the forward alone when autograd records nothing); CPU
    tensors -> the torch chain (``head_plain``, then ``squashed_gaussian``)
    under torch's autograd."""
    noise = noise.contiguous()
    if not h.is_cuda:
        return squashed_gaussian(*head_plain(h, wm, bm, wl, bl, dense), noise)
    args = (h.contiguous(), wm, bm, wl, bl, noise)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SACHeadFn.apply(*args, dense)
    return sac_head(*args, dense)
