"""Resolve the device an entry point runs on: the card unless asked otherwise."""
from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` (the default of every entry point) or ``"cpu"``.

    Raises when CUDA is asked for and absent: an entry point never drops to
    the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
