"""Device placement for the port's entry points.

Numpy (or other array-like) input goes to ``DEFAULT_DEVICE`` unless the
caller names a device; a tensor keeps its own device unless the caller
names another.  Asking for ``cuda`` on a host without a usable card raises:
nothing falls back to the CPU.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike) -> torch.device:
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def as_tensor(x, device: DeviceLike = None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays where it is unless ``device`` is
    given; anything else goes to ``device`` (default ``DEFAULT_DEVICE``)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))
