"""EMLP engine diagnostics (port of
``gym_rotor_tpu/models/emlp/diagnostics.py``): tools for verifying and
inspecting equivariant bases of either engine (the scoped ``reps.SumRep``
and the general ``rep_algebra`` reps), a baseline ``MLP`` and
``standardize``.

Everything but ``sparsify_basis``, ``equivariant_projection``'s
projector and ``MLP`` is host NumPy, as in the JAX package.
``sparsify_basis`` starts from an injected rotation ``W0`` (the JAX
package draws it from ``jax.random``) and writes optax's Adam update out
as a torch loop.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .nn import linear_projector
from .reps import SumRep


def _groups_of(rep):
    if not hasattr(rep, "atoms"):      # general rep_algebra.Rep
        from .rep_algebra import groups_of
        return groups_of(rep)
    seen = []
    for a in rep.atoms:
        if all(a.G != G for G in seen):
            seen.append(a.G)
    return seen


def _size_of(rep) -> int:
    """Scoped SumRep exposes ``size`` as a property; general rep_algebra
    reps as a method."""
    return rep.size if isinstance(rep.size, int) else rep.size()


def _rho_of(rep, assign: Dict) -> np.ndarray:
    """Dense rho under a {Group: element} assignment for either engine."""
    if hasattr(rep, "rho_dense"):      # scoped reps.SumRep
        return rep.rho_dense(assign)
    return rep.rho(assign)


def scale_adjusted_rel_error(t1: np.ndarray, t2: np.ndarray,
                             g: np.ndarray) -> float:
    """Relative error of t1 vs t2, adjusted for the scale of the tensors and
    of the group element."""
    error = np.sqrt(np.mean(np.abs(t1 - t2) ** 2))
    tscale = (np.sqrt(np.mean(np.abs(t1) ** 2))
              + np.sqrt(np.mean(np.abs(t2) ** 2)))
    gscale = np.sqrt(np.mean(np.abs(g - np.eye(g.shape[-1])) ** 2))
    return float(error / max(max(tscale, gscale), 1e-7))


def equivariance_error(W: np.ndarray, rep_in, rep_out, n_samples: int = 5,
                       rng=None) -> float:
    """Equivariance relative error rel_err(W rho_in(g), rho_out(g) W) of a
    matrix W (nout, nin), or a basis Q (nout*nin, r), over sampled group
    elements: one element per group per draw, applied jointly."""
    rng = rng or np.random.default_rng(0)
    nin, nout = _size_of(rep_in), _size_of(rep_out)
    W = np.asarray(W)
    if W.ndim == 1:
        W = W[:, None]
    if W.shape[0] == nout * nin:          # basis (nout*nin, r)
        Ws = W.T.reshape(-1, nout, nin)
    else:                                  # single matrix
        Ws = W.reshape(1, nout, nin)

    groups = _groups_of(rep_in) + [G for G in _groups_of(rep_out)
                                   if all(G != H for H in _groups_of(rep_in))]
    errs = []
    for _ in range(n_samples):
        assign: Dict = {G: G.samples(1, rng)[0] for G in groups}
        rin = _rho_of(rep_in, assign)
        rout = _rho_of(rep_out, assign)
        gref = max((g for g in assign.values()),
                   key=lambda g: g.shape[-1])
        errs.append(scale_adjusted_rel_error(Ws @ rin, rout @ Ws, gref))
    return float(np.max(errs))


def equivariant_projection(rep_in: SumRep, rep_out: SumRep):
    """(P(v), r): the dense equivariant projector onto Hom_G(V_in, V_out)
    applied to a vectorized matrix (a torch function, float32, on the
    vector's device), plus the subspace dimension."""
    Qw, _, mask, _ = linear_projector(rep_in, rep_out)
    mflat = mask.reshape(-1)
    r = int(Qw.shape[1] + mflat.sum())

    def project(v):
        v = torch.as_tensor(v).to(torch.float32).reshape(-1)
        out = torch.as_tensor(mflat, device=v.device) * v
        if Qw.shape[1]:
            Q = torch.as_tensor(Qw, device=v.device)
            out = out + Q @ (Q.T @ v)
        return out

    return project, r


def equivariant_basis(rep_in: SumRep, rep_out: SumRep) -> np.ndarray:
    """Dense orthonormal basis Q (nout*nin, r) of the equivariant
    subspace."""
    Qw, _, mask, _ = linear_projector(rep_in, rep_out)
    cols = [Qw[:, k] for k in range(Qw.shape[1])]
    mflat = mask.reshape(-1)
    for idx in np.nonzero(mflat)[0]:
        e = np.zeros(mflat.size, np.float32)
        e[idx] = 1.0
        cols.append(e)
    if not cols:
        return np.zeros((rep_out.size * rep_in.size, 0), np.float32)
    return np.stack(cols, axis=1)


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8     # optax.adam's defaults


def _sparsify_loss(Q, W):
    r = W.shape[0]
    eye = torch.eye(r, dtype=W.dtype, device=W.device)
    return ((Q @ W.T).abs().mean() + 0.1 * (W.T @ W - eye).abs().mean()
            + 0.01 * torch.linalg.slogdet(W)[1] ** 2)


def sparsify_rotation(Q, W0, lr: float = 1e-2, iters: int = 3000
                      ) -> Tuple[torch.Tensor, bool]:
    """The rotation ``W`` of ``sparsify_basis`` after ``iters`` Adam steps
    from ``W0`` on its loss (optax's ``adam``: b1 0.9, b2 0.999, eps 1e-8,
    bias corrections in the parameters' dtype), and whether the loss
    diverged (past 1e2 after step 100; the steps stop there).  Float32."""
    Q = torch.as_tensor(np.asarray(Q, np.float32))
    W = torch.as_tensor(np.array(W0, np.float32))
    mu, nu = torch.zeros_like(W), torch.zeros_like(W)
    for i in range(iters):
        Wl = W.detach().requires_grad_(True)
        val = _sparsify_loss(Q, Wl)
        (g,) = torch.autograd.grad(val, Wl)
        with torch.no_grad():
            t = i + 1
            mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
            nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu
            mu_hat = mu / torch.tensor(1 - ADAM_B1 ** t, dtype=W.dtype)
            nu_hat = nu / torch.tensor(1 - ADAM_B2 ** t, dtype=W.dtype)
            W = W + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
        if float(val.detach()) > 1e2 and i > 100:
            return W, True
    return W, False


def sparsify_basis(Q: np.ndarray, lr: float = 1e-2, iters: int = 3000,
                   W0: Optional[np.ndarray] = None,
                   generator: Optional[torch.Generator] = None) -> np.ndarray:
    """Rotate an orthonormal basis toward a +-1/0 pattern for
    visualization: minimize mean|QW^T| + orthogonality and log-det
    penalties over W (``sparsify_rotation``), then snap.  ``W0`` (r, r)
    is the starting rotation; without it, the Q of a QR of a normal draw
    from ``generator``.  A diverged run starts again from ``W0`` at a
    third of the rate.  No convergence guarantee: visualization only."""
    Qt = torch.as_tensor(np.asarray(Q, np.float32))
    r = Qt.shape[-1]
    if r == 0:
        return Qt.numpy()
    if W0 is None:
        W0 = torch.linalg.qr(torch.randn(r, r, generator=generator))[0]
    W, diverged = sparsify_rotation(Qt, W0, lr, iters)
    if diverged:
        return sparsify_basis(Q, lr=lr / 3, iters=iters, W0=W0)
    Qs = (Qt @ W.T).numpy().copy()
    Qs[np.abs(Qs) < 1e-2] = 0.0
    nz = np.abs(Qs) > 1e-2
    Qs[nz] /= np.abs(Qs[nz])
    return Qs


def vis(rep_in: SumRep, rep_out: SumRep, path: Optional[str] = None):
    """The tied-weight pattern of the equivariant maps rep_in -> rep_out:
    a seeded random vector projected onto the subspace, (nout, nin); saved
    as a PNG when ``path`` is given (matplotlib, imported only then)."""
    project, _ = equivariant_projection(rep_in, rep_out)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(rep_out.size * rep_in.size)
    img = np.round(project(v).numpy(), 4).reshape(rep_out.size, rep_in.size)
    if path is not None:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        plt.imshow(img)
        plt.axis("off")
        plt.savefig(path, bbox_inches="tight")
        plt.close()
    return img


class MLP(nn.Module):
    """Standard baseline MLP; reps give the shapes only: [Dense + SiLU] *
    num_layers + Dense, Xavier-normal kernels and zero biases, flax's
    names (``Dense_0`` ...) and kernel layout (in, out)."""

    def __init__(self, rep_in, rep_out, ch: int = 384, num_layers: int = 3,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [_size_of(rep_in)] + [ch] * num_layers + [_size_of(rep_out)]
        self.n_layers = num_layers + 1
        for k, (a, b) in enumerate(zip(widths, widths[1:])):
            layer = nn.Module()
            layer.kernel = nn.Parameter(torch.empty(a, b, device=device,
                                                    dtype=dtype))
            layer.bias = nn.Parameter(torch.zeros(b, device=device,
                                                  dtype=dtype))
            with torch.no_grad():
                std = (2.0 / (a + b)) ** 0.5
                layer.kernel.normal_(0.0, std, generator=generator)
            self.add_module(f"Dense_{k}", layer)

    def forward(self, x):
        for k in range(self.n_layers):
            layer = getattr(self, f"Dense_{k}")
            x = x @ layer.kernel + layer.bias
            if k < self.n_layers - 1:
                x = F.silu(x)
        return x


def standardize(apply_fn, ds_stats):
    """Wrap a model apply with dataset normalization stats:
    ``(mu_x, sigma_x)`` normalizes inputs; ``(mu_x, sigma_x, mu_y,
    sigma_y)`` also unnormalizes outputs."""
    if len(ds_stats) == 2:
        mu_in, s_in = ds_stats

        def wrapped(params, x, *a, **kw):
            return apply_fn(params, (x - mu_in) / s_in, *a, **kw)
    else:
        mu_in, s_in, mu_out, s_out = ds_stats

        def wrapped(params, x, *a, **kw):
            return s_out * apply_fn(params, (x - mu_in) / s_in, *a,
                                    **kw) + mu_out
    return wrapped
