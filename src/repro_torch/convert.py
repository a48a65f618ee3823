"""Carry results of the JAX reference over into the port.

The system has no weights: its carried-over state is a fitted PCA
(components, mean and scale), a solved eigen/SVD problem or a DLE pivot.
``to_port`` takes a result of the reference (``PCAResult``, ``EighResult``,
``BatchedPCAResult``, ``BatchedEighResult``, ``BatchedSVDResult``,
``Pivot``), whose fields are arrays numpy can read, and returns the port's
result of the same name with every field a tensor on ``device``.  It
matches the type by name, so this module imports nothing of the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .core.dle import Pivot
from .core.jacobi import EighResult
from .core.pca import PCAResult
from .serving.solver import BatchedEighResult, BatchedPCAResult, BatchedSVDResult

RESULT_TYPES = {cls.__name__: cls for cls in (
    PCAResult, EighResult, BatchedPCAResult, BatchedEighResult,
    BatchedSVDResult, Pivot)}


def to_port(result, device: DeviceLike = None):
    """The port's counterpart of a reference result, on ``device``
    (default ``cuda``)."""
    name = type(result).__name__
    if name not in RESULT_TYPES:
        raise TypeError(f"no port counterpart for {name!r}; known: "
                        f"{sorted(RESULT_TYPES)}")
    cls = RESULT_TYPES[name]
    if tuple(result._fields) != cls._fields:
        raise TypeError(f"{name} fields {result._fields} differ from the "
                        f"port's {cls._fields}")
    dev = resolve_device(device)
    return cls(*(None if v is None
                 else torch.as_tensor(np.array(v), device=dev)
                 for v in result))
