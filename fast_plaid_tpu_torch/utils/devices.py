"""The port's default device: the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

import torch

__all__ = ["NO_CUDA", "default_device"]

NO_CUDA = "No CUDA device available; pass device='cpu' to run on the CPU."


def default_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a ``torch.device``; None means the current CUDA device
    and raises RuntimeError where there is none (no silent CPU fallback)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CUDA)
    return torch.device("cuda", torch.cuda.current_device())
