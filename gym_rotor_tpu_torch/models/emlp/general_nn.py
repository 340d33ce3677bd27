"""General EMLP over arbitrary ``rep_algebra`` representations, as torch
modules (port of ``gym_rotor_tpu/models/emlp/general_nn.py``): channel
allocation (``uniform_rep``), gates, and the ``GeneralEquivLinear``,
``GeneralBiLinear``, ``GeneralGatedNonlinearity``, ``GeneralEMLPBlock`` and
``GeneralEMLP`` modules, for any group of the zoo and any rep built with
the ⊕/⊗/dual algebra.

Parameters are 1:1 with the flax modules (``kernel`` (nout, nin),
``bias``, ``bi_params``; ``convert.general_emlp_params_from_jax``).  The
equivariant subspace of each linear map is solved blockwise on the host,
one small dense basis Q_t per type of the weight rep W = rep_out ⊗ rep_in*
(rounded to float32, as the JAX package's), and the forward projects the
kernel per block with two small matmuls (``_project_kernel``, plain torch:
the general counterpart of K5 ``project_linear``).

``GeneralEMLPBlock`` runs as one K3/K4 block (``kernels/emlp_block.py``):
its bilinear layer's map ``W(x) x`` becomes the list of the quadratic
form's nonzeros (``rep_algebra.bilinear_nonzeros``) and the block goes
through ``block_apply`` with a ``general_block_spec``, the run-time-width
kernels on a CUDA tensor, their plain twins on a CPU tensor.  Its
submodules' own forwards (the dense ``W(x)`` of ``bilinear_weights``) are
the structured reference the tests hold that index to.

Every initialiser takes an explicit ``torch.Generator``; the ragged
remainder of ``binomial_allocation`` draws from a seeded NumPy generator,
as the JAX package's, so layer layouts are the same in both.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from scipy.special import binom
from torch import nn

from ...kernels import emlp_block as K
from .groups import Group
from .rep_algebra import Rep, Scalar, SumRep, T, bilinear_weights


# ----------------------------------------------------------------------------
# Channel allocation heuristics
# ----------------------------------------------------------------------------
def lambertW(ch: int, d: int) -> int:
    """Largest r with (r+1) d^r <= ch."""
    max_rank = 0
    while (max_rank + 1) * d ** max_rank <= ch:
        max_rank += 1
    return max_rank - 1


def binomial_allocation(N: int, rank: int, G: Group,
                        rng: np.random.Generator) -> Union[Rep, int]:
    """Allocate N tensors of total rank r into T(k, r-k) binomially."""
    if N == 0:
        return 0
    n_binoms = N // (2 ** rank)
    n_leftover = N % (2 ** rank)
    even_split = sum(n_binoms * int(binom(rank, k)) * T(k, rank - k, G)
                     for k in range(rank + 1))
    ps = rng.binomial(rank, 0.5, n_leftover)
    ragged = sum(T(int(p), rank - int(p), G) for p in ps)
    return even_split + ragged


def uniform_rep(ch: int, G: Group, seed: int = 0) -> SumRep:
    """Distribute ``ch`` channels evenly across tensor ranks; returns a
    canonicalized general SumRep."""
    d = G.d
    Ns = np.zeros((lambertW(ch, d) + 1,), np.int64)
    while ch > 0:
        max_rank = lambertW(ch, d)
        Ns[:max_rank + 1] += np.array(
            [d ** (max_rank - r) for r in range(max_rank + 1)], dtype=np.int64)
        ch -= (max_rank + 1) * d ** max_rank
    rng = np.random.default_rng(seed)
    rep = sum(binomial_allocation(int(nr), r, G, rng)
              for r, nr in enumerate(Ns))
    canon, _ = rep.canonicalize()
    return canon


# ----------------------------------------------------------------------------
# Gates
# ----------------------------------------------------------------------------
def gated(ch_rep: Rep) -> Rep:
    """Append one scalar 'gate' channel per non-scalar, non-permutation
    summand."""
    if isinstance(ch_rep, SumRep):
        return ch_rep + sum(Scalar(rep.G) for rep in ch_rep
                            if rep != Scalar and not rep.is_permutation)
    if ch_rep.is_permutation:
        return ch_rep
    return ch_rep + Scalar(ch_rep.G)


def gate_indices(ch_rep: Rep) -> np.ndarray:
    """For each of the rep's ``size()`` channels, the index of its gate
    scalar in the gated rep's layout: the channel itself for scalars and
    permutation reps (-> swish), an appended gate otherwise."""
    channels = ch_rep.size()
    if not isinstance(ch_rep, SumRep):
        if ch_rep.is_permutation:
            return np.arange(channels)
        return np.full(channels, channels, dtype=np.int64)
    perm = ch_rep.perm
    indices = np.arange(channels)
    num_nonscalars = 0
    i = 0
    for rep in ch_rep:
        if rep != Scalar and not rep.is_permutation:
            indices[perm[i:i + rep.size()]] = channels + num_nonscalars
            num_nonscalars += 1
        i += rep.size()
    return indices


# ----------------------------------------------------------------------------
# Blockwise weight projection
# ----------------------------------------------------------------------------
_PROJECTORS: Dict[tuple, tuple] = {}


def blockwise_projector(rep_in: Rep, rep_out: Rep):
    """``_blockwise_projector``, made once per pair of reps."""
    key = (rep_in, rep_out)
    hit = _PROJECTORS.get(key)
    if hit is None:
        hit = _PROJECTORS[key] = _blockwise_projector(rep_in, rep_out)
    return hit


def _blockwise_projector(rep_in: Rep, rep_out: Rep):
    """Host-side structure for projecting a dense (nout, nin) kernel onto
    the equivariant subspace of W = rep_out ⊗ rep_in* blockwise: each type
    of the canonical weight rep gets one small dense basis Q_t (size_t,
    r_t), float32, shared across its multiplicity.

    Returns (perm, invperm, blocks) with blocks = [(mult, size, Q or None)]
    in canonical chunk order; Q None marks an all-zero block."""
    W_rep = rep_out * rep_in.t()
    if not isinstance(W_rep, SumRep):
        W_rep = SumRep(W_rep)
    canon, perm = W_rep.canonicalize()
    invperm = np.argsort(perm)
    blocks = []
    for rep_t, mult in canon.reps.items():
        Q = rep_t.equivariant_basis()
        blocks.append((mult, rep_t.size(),
                       None if Q.shape[1] == 0 else np.asarray(Q, np.float32)))
    return np.asarray(perm), invperm, blocks


def _project_kernel(kernel_flat, perm, invperm, blocks):
    """The blockwise projection of a flat (nout*nin,) kernel: reorder to
    canonical, per type c = Qᵀw then w <- Qc, reorder back with
    ``invperm`` (tensors of ``kernel_flat``'s device; ``blocks``' Q as
    tensors in its dtype)."""
    wc = kernel_flat[perm]
    out_chunks = []
    i = 0
    for mult, size, Q in blocks:
        chunk = wc[i:i + mult * size]
        i += mult * size
        if Q is None:
            out_chunks.append(torch.zeros_like(chunk))
            continue
        coeffs = chunk.reshape(mult, size) @ Q
        out_chunks.append((coeffs @ Q.T).reshape(-1))
    return torch.cat(out_chunks)[invperm]


class _Constants(nn.Module):
    """Caches a layer's host arrays as tensors per (device, dtype)."""

    def __init__(self):
        super().__init__()
        self._const: Dict[tuple, object] = {}

    def _cached(self, name, device, dtype, make):
        key = (name, str(device), dtype)
        hit = self._const.get(key)
        if hit is None:
            hit = self._const[key] = make()
        return hit


def _factory(device, dtype):
    return {"device": device, "dtype": dtype}


class GeneralEquivLinear(_Constants):
    """Equivariant linear layer rep_in -> rep_out over general reps:
    orthogonal-init kernel (nout, nin) and uniform bias in
    [0, 1/sqrt(nout)), projected onto the equivariant subspace every
    forward."""

    def __init__(self, rep_in: Rep, rep_out: Rep, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rep_in, self.rep_out = rep_in, rep_out
        nin, nout = rep_in.size(), rep_out.size()
        self.kernel = nn.Parameter(torch.empty(nout, nin,
                                               **_factory(device, dtype)))
        self.bias = nn.Parameter(torch.empty(nout, **_factory(device, dtype)))
        with torch.no_grad():
            nn.init.orthogonal_(self.kernel, generator=generator)
            self.bias.uniform_(0.0, 1.0 / math.sqrt(nout),
                               generator=generator)
        self.perm, self.invperm, self.blocks = blockwise_projector(rep_in,
                                                                   rep_out)
        Qb = np.asarray(rep_out.equivariant_basis(), np.float32)
        self.Qb = Qb if Qb.shape[1] else None

    def _tensors(self, device, dtype, rows):
        """The projection's index and bases on ``device``; ``rows`` (an
        index over the output rows, or None) folded into the kernel's last
        gather, and as a tensor for the bias's."""
        def make():
            nout, nin = self.rep_out.size(), self.rep_in.size()
            inv = self.invperm.reshape(nout, nin)
            if rows is not None:
                inv = inv[rows]
            blocks = [(m, s, None if Q is None
                       else torch.as_tensor(Q).to(device, dtype))
                      for m, s, Q in self.blocks]
            Qb = (None if self.Qb is None
                  else torch.as_tensor(self.Qb).to(device, dtype))
            return (torch.as_tensor(self.perm, device=device),
                    torch.as_tensor(inv.reshape(-1), device=device),
                    blocks, Qb,
                    None if rows is None else torch.as_tensor(rows,
                                                              device=device))
        return self._cached(("proj", None if rows is None else id(rows)),
                            device, dtype, make)

    def effective(self, rows: Optional[np.ndarray] = None):
        """(W_eff (nout, nin), b_eff): the projected weights, differentiable;
        with ``rows`` only those output rows, in that order."""
        perm, inv, blocks, Qb, rows_t = self._tensors(
            self.kernel.device, self.kernel.dtype, rows)
        W = _project_kernel(self.kernel.reshape(-1), perm, inv, blocks)
        W = W.reshape(-1, self.rep_in.size())
        b = (Qb @ (Qb.T @ self.bias) if Qb is not None
             else torch.zeros_like(self.bias))
        return W, (b if rows_t is None else b[rows_t])

    def forward(self, x):
        W, b = self.effective()
        return x @ W.T + b


class GeneralBiLinear(nn.Module):
    """Bilinear layer built from ``rep_algebra.bilinear_weights``: W(x)
    assembled from x's own type components, out = 0.1 * W(x) x (dense
    W(x), the structured reference of the block's nonzero index)."""

    def __init__(self, rep_in: Rep, rep_out: Rep, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rep_in, self.rep_out = rep_in, rep_out
        self.wdim, self.proj = bilinear_weights(rep_out, rep_in)
        self.bi_params = nn.Parameter(torch.empty(max(self.wdim, 1),
                                                  **_factory(device, dtype)))
        with torch.no_grad():
            self.bi_params.normal_(0.0, 1.0, generator=generator)

    def forward(self, x):
        if self.wdim == 0:
            return x.new_zeros(x.shape[:-1] + (self.rep_out.size(),))
        W = self.proj(self.bi_params, x)
        return 0.1 * (W @ x[..., None]).squeeze(-1)


class GeneralGatedNonlinearity(nn.Module):
    """sigmoid(gate) * value per channel; swish on scalar/permutation
    channels."""

    def __init__(self, rep: Rep):
        super().__init__()
        self.rep = rep
        self.idx = gate_indices(rep)

    def forward(self, values):
        gates = values[..., torch.as_tensor(self.idx, device=values.device)]
        return torch.sigmoid(gates) * values[..., :self.rep.size()]


class GeneralEMLPBlock(nn.Module):
    """G-Linear into the gated rep, + BiLinear residual, + gated
    nonlinearity, run as one K3/K4 block (``kernels/emlp_block.py``:
    ``emlp_block_any`` / ``emlp_block_backward_any`` on a CUDA tensor,
    their plain twins on a CPU tensor)."""

    def __init__(self, rep_in: Rep, rep_out: Rep, **kw):
        super().__init__()
        grep = gated(rep_out)
        self.rep_in, self.rep_out, self.grep = rep_in, rep_out, grep
        self.linear = GeneralEquivLinear(rep_in, grep, **kw)
        self.bilinear = GeneralBiLinear(grep, grep, **kw)
        self.nonlinearity = GeneralGatedNonlinearity(rep_out)

    def forward(self, x):
        spec = K.general_block_spec(self, x.device)
        W, b = self.linear.effective(spec.rows)
        v = K.merged_values(spec, self.bilinear.bi_params)
        return K.block_apply(spec, x, W, b, v)

    def forward_layers(self, x):
        """The block through its submodules' own forwards (dense W(x))."""
        lin = self.linear(x)
        preact = self.bilinear(lin) + lin
        return self.nonlinearity(preact)


class GeneralEMLP(nn.Module):
    """Equivariant MLP for arbitrary reps/groups.

    ``ch`` may be an int (``uniform_rep`` heuristic), a Rep, or a sequence
    of ints/Reps; blocks ``block_{i}``, then the equivariant ``head``."""

    def __init__(self, rep_in: Rep, rep_out: Rep, group: Group,
                 ch: Union[int, Rep, Sequence] = 384, num_layers: int = 3,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        G = group
        self.group = G
        rin, rout = rep_in(G), rep_out(G)
        if isinstance(ch, int):
            middle: List[Rep] = num_layers * [uniform_rep(ch, G)]
        elif isinstance(ch, Rep):
            middle = num_layers * [ch(G)]
        else:
            middle = [c(G) if isinstance(c, Rep) else uniform_rep(c, G)
                      for c in ch]
        self.reps = [rin] + middle
        self.rep_in, self.rep_out = rin, rout
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.n_blocks = len(middle)
        for i, (ra, rb) in enumerate(zip(self.reps, self.reps[1:])):
            self.add_module(f"block_{i}", GeneralEMLPBlock(ra, rb, **kw))
        self.head = GeneralEquivLinear(self.reps[-1], rout, **kw)

    def blocks(self):
        return tuple(getattr(self, f"block_{i}")
                     for i in range(self.n_blocks))

    def forward(self, x):
        for blk in self.blocks():
            x = blk(x)
        return self.head(x)
