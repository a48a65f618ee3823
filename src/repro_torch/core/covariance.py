"""Covariance C = X^T X with block streaming (port of
``repro.core.covariance``).

  * ``standardize``        -- zero-mean / unit-variance per feature
  * ``covariance``         -- plain torch
  * ``blocked_covariance`` -- explicit sample-block accumulation (the
                              MM-Engine schedule), or with ``fused=True``
                              the one-launch ``covariance`` op
  * ``distributed_covariance`` -- the same block streaming across a
                              mesh: each data shard accumulates its own
                              X_i^T X_i on its device, and a sum over the
                              shards completes C
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .._device import as_input


def standardize(X, eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Zero-mean / unit-variance per feature over the sample axis (-2),
    population std (paper eq. 1)."""
    mean = torch.mean(X, dim=-2)
    std = torch.std(X, dim=-2, correction=0)
    std = torch.where(std < eps, torch.ones_like(std), std)
    return (X - mean[..., None, :]) / std[..., None, :], mean, std


def covariance(X, normalize: bool = False) -> torch.Tensor:
    """C = X^T X (paper eq. 2); ``normalize`` divides by (M - 1)."""
    C = X.mT @ X
    if normalize:
        C = C / max(X.shape[-2] - 1, 1)
    return C


def blocked_covariance(
    X,
    block_m: int = 128,
    matmul_fn: Optional[Callable] = None,
    normalize: bool = False,
    fused: bool = False,
    precision: str = "fp32",
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Stream sample blocks of ``block_m`` rows, accumulating the partial
    products (the MM-Engine dataflow), for one (m, n) matrix.

    ``fused=True`` routes the whole accumulation through the ``covariance``
    op (one kernel call; ``precision`` picks its operand dtype, ``backend``
    its registry backend) instead of one matmul per block.
    """
    if fused:
        from repro_torch.kernels import ops as kops
        return kops.covariance(X, block_m=block_m, precision=precision,
                               normalize=normalize, backend=backend)
    mm = matmul_fn or torch.matmul
    m, n = X.shape
    pad = (-m) % block_m
    if pad:
        X = torch.nn.functional.pad(X, (0, 0, 0, pad))
    Xb = X.reshape(-1, block_m, n)
    C = mm(Xb[0].mT, Xb[0])
    for xb in Xb[1:]:
        C = C + mm(xb.mT, xb)
    if normalize:
        C = C / max(m - 1, 1)
    return C


def distributed_covariance(
    X,
    mesh,
    data_axis: str = "data",
    matmul_fn: Optional[Callable] = None,
    block_m: int = 128,
) -> torch.Tensor:
    """Block streaming across the mesh (a ``parallel.sharding.Mesh``).

    The rows of the (m, n) ``X`` split evenly over ``data_axis`` in device
    order (m must divide, as the reference's ``P(data_axis, None)``
    requires); each shard runs ``blocked_covariance`` with ``block_m`` on
    its own device (``matmul_fn``, default ``torch.matmul``); the partial
    Grams are summed in shard order on the mesh's first device, where C
    comes back.  Across cards the partial Grams are copied there and
    added one after the other (what ``torch.cuda.comm.reduce_add`` does
    without NCCL, whose reduce picks its own order); over virtual CPU
    devices it is the same sum.  A tensor ``X`` is read where it lies;
    numpy input goes to the first device first.
    """
    if data_axis not in mesh.axis_names:
        raise ValueError(
            f"data_axis {data_axis!r} not in mesh axes {mesh.axis_names}")
    devs = mesh.axis_devices((data_axis,))
    if not isinstance(X, torch.Tensor):
        X = as_input(X, devs[0])
    m = X.shape[0]
    if m % len(devs):
        raise ValueError(
            f"{m} rows do not split evenly over the {len(devs)} devices of "
            f"mesh axis {data_axis!r}")
    rows = m // len(devs)
    parts = []
    for i, dev in enumerate(devs):
        x = X[i * rows:(i + 1) * rows].to(dev, non_blocking=True)
        parts.append(blocked_covariance(x, block_m=block_m,
                                        matmul_fn=matmul_fn))
    C = parts[0]
    for part in parts[1:]:
        C = C + part.to(C.device, non_blocking=True)
    return C
