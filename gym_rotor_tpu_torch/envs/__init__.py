"""envs of the PyTorch/CUDA port."""
from __future__ import annotations

import torch


def state_from_oracle(cfg, o, dtype=torch.float32, device=None):
    """An unbatched ``EnvState`` from a NumPy ``OracleEnv`` on ``device``
    (default: the card; ``envs/__init__.py:11-35``): the oracle's
    reference-ordered draws start the torch env."""
    from ..utils.device import resolve_device
    from .state import EnvState, Goal
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)
    return EnvState(
        x=t(o.x), v=t(o.v), R=t(o.R), W=t(o.W), eIx=t(o.eIx),
        eIx_integrand=t(o.eIx_int), eIb1=t(o.eIb1),
        eIb1_integrand=t(o.eIb1_int), f_total=t(o.p.m * 9.81),
        M=torch.zeros(3, dtype=dtype, device=dev),
        goal=Goal(xd=t(o.xd), vd=t(o.vd), b1d=t(o.b1d), b1d_dot=t(o.b1d_dot),
                  Wd=t(o.Wd)),
        params=params_from_oracle(o.p, dtype, dev),
        t=torch.zeros((), dtype=torch.int32, device=dev))


def params_from_oracle(op, dtype, device):
    """``QuadParams`` from an ``OracleParams`` (``envs/__init__.py:38-44``)."""
    from .params import from_values
    return from_values(op.m, op.d, op.J[0], op.J[2], op.c_tf, op.c_tw, dtype,
                       device)
