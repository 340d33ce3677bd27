"""Device selection shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card.  Asking for CUDA on a machine without one
    raises: the port never falls back to the CPU on its own; the caller
    passes ``device="cpu"`` to get the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gym_rotor_tpu_torch: CUDA requested (the default) but no CUDA "
            "device is available; pass device='cpu' to run the plain path")
    return dev
