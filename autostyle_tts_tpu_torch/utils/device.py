"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. A CUDA device on a machine without CUDA
    raises: the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def upload(a: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host tensor ``a`` on ``device``, without blocking the host: to a card
    it goes through pinned memory as an asynchronous copy (a plain
    ``.to(device)`` from pageable memory waits until the card has finished
    the work queued before it)."""
    if device.type != "cuda":
        return a.to(device)
    return a.pin_memory().to(device, non_blocking=True)
