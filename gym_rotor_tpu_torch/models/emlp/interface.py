"""Equivariant probabilistic IO interface (port of
``gym_rotor_tpu/models/emlp/interface.py``; available, not on the
training path).

* ``group_augmentation``: symmetrize an arbitrary network by averaging over
  sampled group elements, f_sym(x) = E_g[rho_out(g)^{-1} f(rho_in(g) x)].
* ``batched_gram_schmidt``: batched orthonormalization of learned frames.
* ``Interface``: a learned-frame interface: a small scoped EMLP maps
  (noised) inputs to d x d frames, orthonormalized by Gram-Schmidt, which
  act as input-dependent group elements for symmetrization.  Its EMLP runs
  through ``kernels/emlp_block.py::emlp_apply``: the K3/K4 kernels on a
  CUDA tensor, their plain twins on a CPU tensor.

Group samples are drawn on the host (NumPy, ``Group.samples``), so the
same ``np.random.Generator`` gives the JAX package's elements; they, and
``Interface``'s input noise, can also be passed in.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ...kernels.emlp_block import emlp_apply
from .groups import Group
from .nn import EMLP
from .reps import SumRep, Vector, uniform_rep


def _rho_batch(rep: SumRep, G: Group, gs: np.ndarray) -> np.ndarray:
    """Dense block-diagonal rho for a batch of sampled elements."""
    return np.stack([rep.rho_dense({G: g}) for g in gs])


def group_augmentation(model_fn: Callable, rep_in: SumRep, rep_out: SumRep,
                       G: Group, x: torch.Tensor, n_samples: int = 1,
                       rng: Optional[np.random.Generator] = None,
                       gs: Optional[np.ndarray] = None) -> torch.Tensor:
    """Symmetrize ``model_fn`` over ``n_samples`` group elements per row:
    ``gs`` (``(n_samples * B, d, d)``, sample-major) or
    ``G.samples(n_samples * B, rng)``.  The rho applications run on
    ``x``'s device."""
    x_rep = x.unsqueeze(0).expand((n_samples,) + tuple(x.shape)).reshape(
        (-1,) + tuple(x.shape[1:]))
    if gs is None:
        gs = G.samples(x_rep.shape[0], rng or np.random.default_rng(0))
    rho_in = torch.as_tensor(_rho_batch(rep_in, G, gs)).to(x.device, x.dtype)
    rho_out_inv = torch.as_tensor(
        np.linalg.inv(_rho_batch(rep_out, G, gs))).to(x.device, x.dtype)
    y = model_fn(torch.einsum("bij,bj->bi", rho_in, x_rep))
    y = torch.einsum("bij,bj->bi", rho_out_inv, y)
    return y.reshape((n_samples, -1) + tuple(y.shape[1:])).mean(0)


def batched_projection(bu, bv):
    """Projection of bv onto bu, batched."""
    return (bv * bu).sum(-1, keepdim=True) / (bu * bu).sum(
        -1, keepdim=True) * bu


def batched_gram_schmidt(bvv):
    """Batched Gram-Schmidt over column frames (B, d, k)."""
    nk = bvv.shape[2]
    cols = [bvv[:, :, 0]]
    for k in range(1, nk):
        bvk = bvv[:, :, k]
        buk = 0
        for j in range(k):
            buk = buk + batched_projection(cols[j], bvk)
        cols.append(bvk - buk)
    cols = [c / torch.linalg.vector_norm(c, dim=-1, keepdim=True)
            for c in cols]
    return torch.stack(cols, dim=2)


class Interface(nn.Module):
    """Learned-frame symmetrization: a scoped ``EMLP`` ``io`` maps noised
    inputs to d*d frame vectors; Gram-Schmidt orthonormalizes them into
    per-sample group elements used for input/output conjugation of
    ``model`` (a function of ``(B, rep_in.size)`` rows).  Parameters as
    flax's: ``noise_scale`` (ones) and ``io.*``."""

    def __init__(self, model: Callable, rep_in: SumRep, rep_out: SumRep,
                 group: Group, io_ch: int = 384, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # the wrapped network is no submodule: its parameters are its own,
        # as flax's ``model`` field is an apply function with them bound
        self.__dict__["model"] = model
        self.rep_in, self.rep_out = rep_in, rep_out
        self.group = group
        d = group.d
        self.noise_scale = nn.Parameter(torch.ones(rep_in.size, device=device,
                                                   dtype=dtype))
        self.io = EMLP((rep_in, uniform_rep(io_ch, group)), Vector(group) * d,
                       device=device, dtype=dtype, generator=generator)

    def forward(self, x, z: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``z``: the input noise, one (rep_in.size,) vector for every row
        (drawn from ``generator`` when not given)."""
        d = self.group.d
        if z is None:
            z = torch.randn(self.rep_in.size, generator=generator,
                            dtype=x.dtype, device=x.device)
        params = dict(self.io.named_parameters())
        frames = emlp_apply(self.io, params, "", x + self.noise_scale * z)
        frames = frames.reshape(x.shape[0], d, d).transpose(1, 2)
        gs = batched_gram_schmidt(frames)
        rho_in = _rho_apply(self.rep_in, gs)
        y = self.model(torch.einsum("bij,bj->bi", rho_in, x))
        rho_out_inv = torch.linalg.inv(_rho_apply(self.rep_out, gs))
        return torch.einsum("bij,bj->bi", rho_out_inv, y)


def _rho_apply(rep: SumRep, gs):
    """Block-diagonal rho(g) for per-sample frames: every atom of the
    frame's group transforms by kron powers of g; other groups' atoms get
    identity.  Supports rank <= 2 atoms."""
    B, d = gs.shape[0], gs.shape[-1]
    n = rep.size
    out = gs.new_zeros((B, n, n))
    off = 0
    for a in rep.atoms:
        if a.rank == 0 or a.G.d != d:
            blk = torch.eye(a.size, dtype=gs.dtype, device=gs.device).expand(
                B, a.size, a.size)
        elif a.rank == 1:
            blk = gs
        elif a.rank == 2:
            blk = torch.einsum("bij,bkl->bikjl", gs, gs).reshape(B, d * d,
                                                                 d * d)
        else:
            raise NotImplementedError("rank > 2 frames")
        s = blk.shape[-1]
        out[:, off:off + s, off:off + s] = blk
        off += s
    return out
