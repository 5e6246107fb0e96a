"""Device resolution shared by every public entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The card unless the caller asks for something else.

    ``None`` means CUDA; without a visible GPU that raises instead of
    carrying on quietly on the CPU. ``device="cpu"`` is the explicit way to
    run the port's plain PyTorch path (the CPU tests do this)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; the port runs on the GPU by "
                "default — pass device='cpu' to run its plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is visible")
    return dev
