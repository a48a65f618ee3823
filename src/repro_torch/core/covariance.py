"""Covariance C = X^T X with block streaming (port of
``repro.core.covariance``).

  * ``standardize``        -- zero-mean / unit-variance per feature
  * ``covariance``         -- plain torch
  * ``blocked_covariance`` -- explicit sample-block accumulation (the
                              MM-Engine schedule), or with ``fused=True``
                              the one-launch ``covariance`` op

``distributed_covariance`` is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


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
