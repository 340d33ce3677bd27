"""Quadrotor physical parameters (port of ``gym_rotor_tpu/envs/params.py``).

Every field carries the batch as its leading dim(s); ``J`` is ``(..., 3)``
and the mixing matrices ``(..., 4, 4)``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .draws import uniform_in

G_STD = 9.81
M_NOMINAL = 2.15
D_NOMINAL = 0.23
J_NOMINAL = (0.022, 0.022, 0.035)
C_TF_NOMINAL = 0.0135
C_TW_NOMINAL = 2.2
MIN_FORCE = 0.5


@dataclass
class QuadParams:
    m: torch.Tensor
    d: torch.Tensor
    J: torch.Tensor
    c_tf: torch.Tensor
    c_tw: torch.Tensor
    hover_force: torch.Tensor
    min_force: torch.Tensor
    max_force: torch.Tensor
    avrg_act: torch.Tensor
    scale_act: torch.Tensor
    forces_to_fM: torch.Tensor
    fM_to_forces: torch.Tensor


def _rows4(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _derive(m, d, J, c_tf, c_tw) -> QuadParams:
    """Derived force limits and mixing matrices (params.py:43-80)."""
    hover_force = m * G_STD / 4.0
    min_force = torch.full_like(m, MIN_FORCE)
    max_force = c_tw * hover_force
    avrg_act = (min_force + max_force) / 2.0
    scale_act = max_force - avrg_act
    z = torch.zeros_like(d)
    o = torch.ones_like(d)
    forces_to_fM = _rows4([[o, o, o, o], [z, -d, z, d], [d, z, -d, z],
                           [-c_tf, c_tf, -c_tf, c_tf]])
    q = 0.25 * o
    hd = 1.0 / (2.0 * d)
    qc = 1.0 / (4.0 * c_tf)
    fM_to_forces = _rows4([[q, z, hd, -qc], [q, -hd, z, qc],
                           [q, z, -hd, -qc], [q, hd, z, qc]])
    return QuadParams(m=m, d=d, J=J, c_tf=c_tf, c_tw=c_tw,
                      hover_force=hover_force, min_force=min_force,
                      max_force=max_force, avrg_act=avrg_act,
                      scale_act=scale_act, forces_to_fM=forces_to_fM,
                      fM_to_forces=fM_to_forces)


def nominal(batch=(), dtype=torch.float32, device=None) -> QuadParams:
    """Nominal (eval / no-UDM) parameters, broadcast to ``batch``."""
    def full(v):
        return torch.full(tuple(batch), v, dtype=dtype, device=device)
    J = torch.stack([full(j) for j in J_NOMINAL], dim=-1)
    return _derive(full(M_NOMINAL), full(D_NOMINAL), J, full(C_TF_NOMINAL),
                   full(C_TW_NOMINAL))


def randomize(u6: torch.Tensor, udm_percentage: float = 10.0) -> QuadParams:
    """Uniform domain randomization around nominal (params.py:93-111):
    m, d, J1(=J2), J3, c_tf ~ U(+-p%), c_tw ~ U(+-p/2 %).  ``u6`` holds
    the six base draws in that order, shape ``(..., 6)``."""
    dtype, device = u6.dtype, u6.device
    u = udm_percentage / 100.0
    nom = torch.tensor([M_NOMINAL, D_NOMINAL, J_NOMINAL[0], J_NOMINAL[2],
                        C_TF_NOMINAL, C_TW_NOMINAL], dtype=dtype, device=device)
    frac = torch.tensor([u, u, u, u, u, u / 2.0], dtype=dtype, device=device)
    z = uniform_in(u6, -1.0, 1.0)
    vals = nom + nom * frac * z
    m, d, J1, J3, c_tf, c_tw = vals.unbind(-1)
    J = torch.stack([J1, J1, J3], dim=-1)
    return _derive(m, d, J, c_tf, c_tw)


def from_values(m, d, J1, J3, c_tf, c_tw, dtype=torch.float64,
                device=None) -> QuadParams:
    """Parameters from values drawn elsewhere (``params.py:114-123``: the
    NumPy oracle's draws, in the reference's order), unbatched."""
    def t(v):
        return torch.tensor(float(v), dtype=dtype, device=device)
    J = torch.stack([t(J1), t(J1), t(J3)], dim=-1)
    return _derive(t(m), t(d), J, t(c_tf), t(c_tw))
