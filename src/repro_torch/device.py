"""Device selection for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fallback."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and this
    process has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but this process has no "
            "CUDA device; pass device='cpu' to run on the CPU")
    return dev


__all__ = ["resolve_device"]
