"""Device placement and input dtypes for the port's entry points.

Numpy (or other array-like) input goes to ``DEFAULT_DEVICE`` unless the
caller names a device; a tensor keeps its own device unless the caller
names another.  Asking for ``cuda`` on a host without a usable card raises:
nothing falls back to the CPU.

Floating input is taken as ``jnp.asarray`` takes it in the reference, where
x64 is off: float32 and bfloat16 keep their dtype and any other floating
dtype (numpy's default float64 above all) becomes float32.  The exception
is ``precision="fp64"``, the port's native float64 lane, which takes
floating input as float64.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"

DeviceLike = Union[str, torch.device, None]

# floating dtypes an entry point keeps outside the fp64 lane
KEPT_DTYPES = (torch.float32, torch.bfloat16)


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


def as_input(x, device: DeviceLike = None,
             precision: str = "fp32") -> torch.Tensor:
    """``as_tensor`` with the dtype rule of the module docstring.  Numpy
    input is converted on the host, before it moves; a tensor that is
    already in its dtype on its device is returned as it is (no copy)."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if a.dtype.kind == "f":
            a = a.astype(np.float64 if precision == "fp64" else np.float32,
                          copy=False)
        return as_tensor(a, device)
    want = x.dtype
    if want.is_floating_point:
        want = (torch.float64 if precision == "fp64"
                else want if want in KEPT_DTYPES else torch.float32)
    if device is None:
        return x.to(want)
    return x.to(device=resolve_device(device), dtype=want)
