"""Equivariant MLP layers as torch modules (port of
``gym_rotor_tpu/models/emlp/nn.py``).

Parameters stay 1:1 with the flax modules (``kernel``, ``bias``,
``bi_params``, same shapes and layout), so a flax tree loads directly
(``convert.actor_params_from_jax``).  The forward here is the structured
plain version: ``EquivLinear`` projects its raw kernel on every call
(``project_linear``) and ``EquivBiLinear`` runs the per-type regimes of
``_bilinear_struct`` exactly as the JAX layer does.  ``bilinear_sparse``
builds the equivalent list of the quadratic form's nonzeros (index-built
from the same structure) that the fused actor kernel uses.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .reps import (Atom, SumRep, group_by_type, pair_basis, product_type_key,
                   vec_basis)

BILINEAR_SEED = 2024  # fixed rng for the bilinear input sampling


def gated(rep: SumRep) -> SumRep:
    """Append one gate scalar per non-scalar, non-permutation atom."""
    gates = [Atom(a.G, 0, 0) for a in rep.atoms
             if not a.is_scalar and not a.is_permutation]
    return SumRep(rep.atoms + gates)


def gate_indices(rep: SumRep) -> np.ndarray:
    """Per-coordinate gate source index into the gated vector; non-gated
    coordinates point at themselves (=> SiLU)."""
    size = rep.size
    idx = np.arange(size)
    off = 0
    gate_pos = size
    for a in rep.atoms:
        if not a.is_scalar and not a.is_permutation:
            idx[off:off + a.size] = gate_pos
            gate_pos += 1
        off += a.size
    return idx


_LINEAR_PROJ_CACHE: Dict[tuple, tuple] = {}


def linear_projector(rep_in: SumRep, rep_out: SumRep):
    """Dense orthonormal bases (Qw, Qb) and pass-through masks of the
    equivariant weight/bias subspaces (nn.py:150-204), float32 like the
    JAX package's (also on its float64 path)."""
    ck = (hash(rep_in), hash(rep_out))
    if ck in _LINEAR_PROJ_CACHE:
        return _LINEAR_PROJ_CACHE[ck]
    nin, nout = rep_in.size, rep_out.size
    mask = np.zeros((nout, nin))
    cols = []
    r_off = 0
    for ao in rep_out.atoms:
        c_off = 0
        for ai in rep_in.atoms:
            B = pair_basis(ao, ai)
            if ao.size == 1 and ai.size == 1:
                if B.shape[1]:
                    mask[r_off, c_off] = 1.0
            else:
                for k in range(B.shape[1]):
                    blk = B[:, k].reshape(ao.size, ai.size)
                    col = np.zeros((nout, nin))
                    col[r_off:r_off + ao.size, c_off:c_off + ai.size] = blk
                    cols.append(col.reshape(-1))
            c_off += ai.size
        r_off += ao.size
    Qw = np.stack(cols, axis=1) if cols else np.zeros((nout * nin, 0))
    bmask = np.zeros(nout)
    bcols = []
    r_off = 0
    for ao in rep_out.atoms:
        Bv = vec_basis(ao)
        if ao.size == 1:
            if Bv.shape[1]:
                bmask[r_off] = 1.0
        else:
            for k in range(Bv.shape[1]):
                col = np.zeros(nout)
                col[r_off:r_off + ao.size] = Bv[:, k]
                bcols.append(col)
        r_off += ao.size
    Qb = np.stack(bcols, axis=1) if bcols else np.zeros((nout, 0))
    out = (Qw.astype(np.float32), Qb.astype(np.float32),
           mask.astype(np.float32), bmask.astype(np.float32))
    _LINEAR_PROJ_CACHE[ck] = out
    return out


_CONST_CACHE: Dict[tuple, tuple] = {}


def _projector_tensors(rep_in: SumRep, rep_out: SumRep, device, dtype):
    """``linear_projector``'s arrays as tensors on ``device``, made once per
    (reps, device, dtype): the training path projects every layer on every
    update, and a host-to-device copy per call would dominate it."""
    key = (hash(rep_in), hash(rep_out), str(device), dtype)
    hit = _CONST_CACHE.get(key)
    if hit is None:
        hit = _CONST_CACHE[key] = tuple(
            torch.as_tensor(a, device=device).to(dtype)
            for a in linear_projector(rep_in, rep_out))
    return hit


def project_linear(rep_in: SumRep, rep_out: SumRep, kernel, bias):
    """W_eff = mask * W + Qw Qwᵀ vec(W); b_eff likewise (nn.py:207-220).
    This is K5 (the fold): once per parameter set on the acting path, once
    per loss on the training path, differentiable."""
    nout, nin = kernel.shape
    Qw, Qb, mask, bmask = _projector_tensors(rep_in, rep_out, kernel.device,
                                             kernel.dtype)
    W_eff = mask * kernel
    if Qw.shape[1]:
        W_eff = W_eff + (Qw @ (Qw.T @ kernel.reshape(-1))).reshape(nout, nin)
    b_eff = bmask * bias
    if Qb.shape[1]:
        b_eff = b_eff + Qb @ (Qb.T @ bias)
    return W_eff, b_eff


def _bilinear_struct(rep: SumRep):
    """Static structure of the bilinear layer for in_rep == out_rep == rep
    (nn.py:223-316, same draws from ``BILINEAR_SEED``): the sampled
    input-mixing indices are drawn once per product type and shared by
    every (type_out, type_in) pair of that type.  Regimes: ``pairs``
    (multi-dimensional product types), ``big``, ``col_groups``,
    ``row_groups`` and ``s1`` (scalar product types), then a type-major
    assembly re-ordered by ``pos``."""
    tg = group_by_type(rep)
    x_types = {t.key: t for t in tg if t.atom.rank >= 1}
    rng = np.random.default_rng(BILINEAR_SEED)
    bids = {t.key: rng.integers(0, t.mult, size=min(t.mult, t.atom.size))
            for t in tg if t.atom.rank >= 1}
    pairs = []
    big = []
    col_groups: dict = {}
    row_groups: dict = {}
    s1_ios, s1_cols, s1_sels, s1_pidx = [], [], [], []
    wdim = 0
    tau_io = {t.key: j for j, t in enumerate(tg)}
    for io, to in enumerate(tg):
        for ii, ti in enumerate(tg):
            tau = product_type_key(to.atom, ti.atom)
            if tau not in x_types:
                continue
            xt = x_types[tau]
            d_tau = xt.atom.size
            if to.atom.size == 1 and ti.atom.size == 1 and d_tau == 1:
                gate = int(xt.indices[bids[tau][0]])
                mo, mi = to.mult, ti.mult
                off = wdim
                wdim += mo * mi
                if mo >= 2 and mi >= 2:
                    big.append(dict(io=io, ii=ii, off=off, gate=gate))
                elif mo >= 2:
                    col_groups.setdefault(io, []).append(
                        dict(off=off, col=int(ti.indices[0]), gate=gate))
                elif mi >= 2:
                    row_groups.setdefault(ii, []).append(
                        dict(off=off, io=io, gate=gate))
                else:
                    s1_ios.append(io)
                    s1_cols.append(int(ti.indices[0]))
                    s1_sels.append(gate)
                    s1_pidx.append(off)
                continue
            n = min(xt.mult, d_tau)
            slots = to.mult * ti.mult
            pairs.append(dict(io=io, ii=ii, tau=tau, tau_io=tau_io[tau],
                              n=n, sel=bids[tau], offset=wdim, slots=slots))
            wdim += slots * n
    s1 = None
    if s1_ios:
        s1 = dict(ios=np.asarray(s1_ios), cols=np.asarray(s1_cols),
                  sels=np.asarray(s1_sels), pidx=np.asarray(s1_pidx))
    cat_idx = np.concatenate([t.indices for t in tg])
    pos = np.empty_like(cat_idx)
    pos[cat_idx] = np.arange(cat_idx.size)
    return tg, dict(pairs=pairs, big=big, col_groups=col_groups,
                    row_groups=row_groups, s1=s1, pos=pos), wdim


def bilinear_dense_index(rep: SumRep):
    """Index form of the bilinear quadratic map: four int arrays
    ``(j, o, i, p)`` such that the layer computes
    ``out[o] = 0.1 * sum over entries of bi_params[p] * x[j] * x[i]``.
    Built from ``_bilinear_struct``, regime by regime; ``j`` is always the
    sampled (gate/mixing) coordinate and ``i`` the multiplied one."""
    tg, st, wdim = _bilinear_struct(rep)
    cat_idx = np.concatenate([t.indices for t in tg])   # tm coord -> coord
    tm_off = np.concatenate([[0], np.cumsum([t.mult * t.atom.size
                                             for t in tg])])
    J, O, I, P = [], [], [], []

    def emit(j, tm, i, p):
        J.append(int(j)); O.append(int(cat_idx[tm])); I.append(int(i))
        P.append(int(p))

    for pr in st["pairs"]:
        to, ti = tg[pr["io"]], tg[pr["ii"]]
        xt_idx = tg[pr["tau_io"]].indices
        do, mo, di, mi = to.atom.size, to.mult, ti.atom.size, ti.mult
        d_tau = do * di
        for o in range(mo):
            for m in range(mi):
                k = o * mi + m
                for nn_, s in enumerate(pr["sel"]):
                    p = pr["offset"] + k * pr["n"] + nn_
                    for dd in range(do):
                        for e in range(di):
                            j = xt_idx[int(s) * d_tau + dd * di + e]
                            emit(j, tm_off[pr["io"]] + o * do + dd,
                                 ti.indices[m * di + e], p)
    for b in st["big"]:
        to, ti = tg[b["io"]], tg[b["ii"]]
        for o in range(to.mult):
            for m in range(ti.mult):
                emit(b["gate"], tm_off[b["io"]] + o, ti.indices[m],
                     b["off"] + o * ti.mult + m)
    for io, grp in st["col_groups"].items():
        for g in grp:
            for o in range(tg[io].mult):
                emit(g["gate"], tm_off[io] + o, g["col"], g["off"] + o)
    for ii, grp in st["row_groups"].items():
        ti = tg[ii]
        for g in grp:
            for m in range(ti.mult):
                emit(g["gate"], tm_off[g["io"]], ti.indices[m], g["off"] + m)
    s1 = st["s1"]
    if s1 is not None:
        for io, col, sel, p in zip(s1["ios"], s1["cols"], s1["sels"],
                                   s1["pidx"]):
            emit(sel, tm_off[io], col, p)
    return tuple(np.asarray(a, np.int64) for a in (J, O, I, P))


_SPARSE_CACHE: Dict[tuple, Dict[str, torch.Tensor]] = {}


def bilinear_index(rep: SumRep, device) -> Dict[str, torch.Tensor]:
    """The static index side of ``bilinear_sparse``, made once per (rep,
    device): ``merge_nonzeros`` of ``bilinear_dense_index``."""
    key = (hash(rep), str(device))
    hit = _SPARSE_CACHE.get(key)
    if hit is None:
        hit = _SPARSE_CACHE[key] = merge_nonzeros(
            *bilinear_dense_index(rep), rep.size, device)
    return hit


def merge_nonzeros(J, O, I, P, n: int, device) -> Dict[str, torch.Tensor]:
    """A quadratic form's nonzeros ``(J, O, I, P)`` over ``n`` coordinates
    (``out[o] = sum of params[P] x[J] x[I]``), merged: the distinct
    ``o``, ``j``, ``i`` (sorted by ``o``, then ``j``, ``i``), the merge
    map (``params[P]`` summed into entry ``inv``), and the kernels' int32
    forms: ``rowptr`` (``n + 1``; the nonzeros of output ``o`` are
    ``rowptr[o]:rowptr[o + 1]``) and ``ji = j << 16 | i``."""
    uniq, inv = np.unique((O * n + J) * n + I, return_inverse=True)
    o, j, i = uniq // (n * n), uniq // n % n, uniq % n

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)
    return dict(
        o=t(o), j=t(j), i=t(i), inv=t(inv.reshape(-1)), P=t(P),
        rowptr=t(np.searchsorted(o, np.arange(n + 1)), torch.int32),
        ji=t(j * 65536 + i, torch.int32), o32=t(o, torch.int32))


def bilinear_sparse(rep: SumRep, bi_params: torch.Tensor):
    """Sparse form of the bilinear map, the only nonzeros of the quadratic
    form: ``(o, j, i, v)``, sorted by output ``o`` (then ``j``, ``i``), with
    ``bilinear(x)[o] = 0.1 * sum over entries e with o[e] == o of
    v[e] * x[j[e]] * x[i[e]]``.  Entries of the same ``(o, j, i)`` are
    merged (their ``bi_params`` summed); ``v`` is differentiable in
    ``bi_params`` (``index_add_``)."""
    idx = bilinear_index(rep, bi_params.device)
    v = torch.zeros(idx["o"].numel(), dtype=bi_params.dtype,
                    device=bi_params.device).index_add_(
        0, idx["inv"], bi_params[idx["P"]])
    return idx["o"], idx["j"], idx["i"], v


class _Indexed(nn.Module):
    """Caches the layers' static numpy index arrays as tensors per device."""

    def __init__(self):
        super().__init__()
        self._idx_cache: Dict[tuple, tuple] = {}

    def _t(self, arr, device, dtype=None):
        key = (id(arr), str(device), dtype)
        hit = self._idx_cache.get(key)
        if hit is None:
            t = torch.as_tensor(np.asarray(arr), device=device)
            if dtype is not None:
                t = t.to(dtype)
            # keep ``arr`` alive so its id cannot be reused by another array
            hit = self._idx_cache[key] = (t, arr)
        return hit[0]


def _factory(device, dtype):
    return {"device": device, "dtype": dtype}


class EquivLinear(nn.Module):
    """Equivariant linear layer rep_in -> rep_out; the raw kernel is
    projected on every forward, as in the reference."""

    def __init__(self, rep_in: SumRep, rep_out: SumRep, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rep_in, self.rep_out = rep_in, rep_out
        nin, nout = rep_in.size, rep_out.size
        self.kernel = nn.Parameter(torch.empty(nout, nin, **_factory(device, dtype)))
        self.bias = nn.Parameter(torch.empty(nout, **_factory(device, dtype)))
        with torch.no_grad():
            nn.init.orthogonal_(self.kernel, generator=generator)
            self.bias.uniform_(0.0, 1.0 / math.sqrt(nout), generator=generator)

    def effective(self):
        """(W_eff, b_eff): the projected weights (K5's fold)."""
        return project_linear(self.rep_in, self.rep_out, self.kernel, self.bias)

    def forward(self, x):
        W_eff, b_eff = self.effective()
        return x @ W_eff.T + b_eff


class EquivBiLinear(_Indexed):
    """Cheap equivariant bilinear layer: W(x) @ x * 0.1 (nn.py:319-418)."""

    def __init__(self, rep: SumRep, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rep = rep
        self.tg, self.st, self.wdim = _bilinear_struct(rep)
        if self.wdim:
            self.bi_params = nn.Parameter(
                torch.empty(self.wdim, **_factory(device, dtype)))
            with torch.no_grad():
                self.bi_params.normal_(0.0, 1.0, generator=generator)
        tg = self.tg
        self.tm_off = np.concatenate(
            [[0], np.cumsum([t.mult * t.atom.size for t in tg])])
        coords = []
        for ii, grp in self.st["row_groups"].items():
            coords.append(np.asarray([self.tm_off[g["io"]] for g in grp]))
        if self.st["s1"] is not None:
            coords.append(self.tm_off[self.st["s1"]["ios"]])
        self.route = None
        if coords:
            c = np.concatenate(coords)
            self.route = np.zeros((c.size, int(self.tm_off[-1])), np.float32)
            self.route[np.arange(c.size), c] = 1.0
        self.col_arrays = {io: (np.asarray([g["col"] for g in grp]),
                                np.asarray([g["gate"] for g in grp]))
                           for io, grp in self.st["col_groups"].items()}
        self.row_gates = {ii: np.asarray([g["gate"] for g in grp])
                          for ii, grp in self.st["row_groups"].items()}
        self.big_gates = [np.asarray([b["gate"]]) for b in self.st["big"]]

    def forward(self, x):
        if self.wdim == 0:
            return torch.zeros_like(x)
        params = self.bi_params
        dev = x.device
        bshape = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1])
        B = xf.shape[0]
        tg, st = self.tg, self.st
        acc = {}

        def add(io, val):
            acc[io] = acc[io] + val if io in acc else val

        def g(arr):
            return xf[:, self._t(arr, dev)]

        if st["pairs"]:
            xg = {t.key: g(t.indices).reshape(B, t.mult, t.atom.size)
                  for t in tg}
            for p in st["pairs"]:
                to, ti = tg[p["io"]], tg[p["ii"]]
                do, mo = to.atom.size, to.mult
                di, mi = ti.atom.size, ti.mult
                x_tau = xg[p["tau"]][:, self._t(p["sel"], dev), :]
                w = params[p["offset"]:p["offset"] + p["slots"] * p["n"]]
                w = w.reshape(mo * mi, p["n"])
                blocks = torch.einsum("kn,bnd->bkd", w, x_tau)
                blocks = blocks.reshape(B, mo, mi, do, di)
                y = torch.einsum("bomde,bme->bod", blocks, xg[ti.key])
                add(p["io"], y.reshape(B, mo * do))
        for p, gate in zip(st["big"], self.big_gates):
            to, ti = tg[p["io"]], tg[p["ii"]]
            W = params[p["off"]:p["off"] + to.mult * ti.mult]
            W = W.reshape(to.mult, ti.mult)
            add(p["io"], (g(ti.indices) @ W.T) * g(gate))
        for io, grp in st["col_groups"].items():
            to = tg[io]
            cols, gates = self.col_arrays[io]
            Ws = torch.stack([params[q["off"]:q["off"] + to.mult] for q in grp])
            Z = g(gates) * g(cols)
            add(io, Z @ Ws)
        small_cols = []
        for ii, grp in st["row_groups"].items():
            ti = tg[ii]
            Wr = torch.stack([params[q["off"]:q["off"] + ti.mult] for q in grp],
                             dim=1)
            small_cols.append((g(ti.indices) @ Wr) * g(self.row_gates[ii]))
        s1 = st["s1"]
        if s1 is not None:
            w1 = params[self._t(s1["pidx"], dev)]
            small_cols.append(w1 * g(s1["sels"]) * g(s1["cols"]))
        out_tm = torch.cat(
            [acc[io] if io in acc
             else torch.zeros(B, t.mult * t.atom.size, dtype=xf.dtype, device=dev)
             for io, t in enumerate(tg)], dim=-1)
        if small_cols:
            Yall = torch.cat(small_cols, dim=-1)
            out_tm = out_tm + Yall @ self._t(self.route, dev, xf.dtype)
        out = out_tm[:, self._t(st["pos"], dev)]
        return (0.1 * out).reshape(bshape + (x.shape[-1],))


class GatedNonlinearity(_Indexed):
    """sigmoid(x[gate_idx]) * x[:size] (nn.py:421-428)."""

    def __init__(self, rep: SumRep):
        super().__init__()
        self.rep = rep
        self.idx = gate_indices(rep)

    def forward(self, values):
        gates = values[..., self._t(self.idx, values.device)]
        return torch.sigmoid(gates) * values[..., :self.rep.size]


class EMLPBlock(nn.Module):
    """G-Linear -> (+ BiLinear) -> gated nonlinearity."""

    def __init__(self, rep_in: SumRep, rep_out: SumRep, **kw):
        super().__init__()
        grep = gated(rep_out)
        self.rep_in, self.rep_out = rep_in, rep_out
        self.linear = EquivLinear(rep_in, grep, **kw)
        self.bilinear = EquivBiLinear(grep, **kw)
        self.nonlinearity = GatedNonlinearity(rep_out)

    def forward(self, x):
        lin = self.linear(x)
        preact = self.bilinear(lin) + lin
        return self.nonlinearity(preact)


class EMLP(nn.Module):
    """EMLPBlocks over ``reps`` then a final EquivLinear ``head``."""

    def __init__(self, reps: Sequence[SumRep], rep_out: SumRep, **kw):
        super().__init__()
        self.n_blocks = len(reps) - 1
        for i, (rin, rout) in enumerate(zip(reps, reps[1:])):
            self.add_module(f"block{i}", EMLPBlock(rin, rout, **kw))
        self.head = EquivLinear(reps[-1], rep_out, **kw)

    def blocks(self) -> Tuple[EMLPBlock, ...]:
        return tuple(getattr(self, f"block{i}") for i in range(self.n_blocks))

    def named_blocks(self, prefix: str = ""):
        """``[(dotted prefix of the block's parameters, block)]``."""
        return [(f"{prefix}block{i}.", b) for i, b in enumerate(self.blocks())]

    def named_head(self, prefix: str = ""):
        return f"{prefix}head.", self.head

    def forward(self, x):
        for blk in self.blocks():
            x = blk(x)
        return self.head(x)


def spectral_weights(params: Dict[str, torch.Tensor]):
    """Raw weight matrices and bilinear params for the spectral-norm
    regularizer (nn.py:533): ``params`` maps dotted flax paths
    (``network.block0.linear.kernel``) to tensors; walked in sorted key
    order (the flax tree's), every ``kernel`` is a weight and every
    ``bi_params`` an extra; ``log_std_linear`` (the SAC head outside the
    equivariant network) is skipped."""
    ws, extras = [], []
    for name in sorted(params, key=lambda n: tuple(n.split("."))):
        parts = name.split(".")
        if "log_std_linear" in parts:
            continue
        if parts[-1] == "kernel":
            ws.append(params[name])
        elif parts[-1] == "bi_params":
            extras.append(params[name])
    return ws, extras
