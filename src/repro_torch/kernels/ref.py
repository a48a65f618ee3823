"""Plain PyTorch versions of the hot-path kernels (port of the reference
oracles in ``repro.kernels.ref``).

Each function is what the CUDA kernel computes, written with ordinary
tensor operations.  The kernel wrappers run these for tensors that lie on
the CPU, and ``chip_smoke.py`` holds each kernel against them on the card.
All three take one problem (2-D) or a batch with leading dimensions.
"""
from __future__ import annotations

from typing import Optional

import torch


def mm_engine(a: torch.Tensor, b: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a @ b with a float32 accumulator (float64 for float64 operands);
    the output has a's dtype."""
    out_dtype = out_dtype or a.dtype
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    return torch.matmul(a.to(acc), b.to(acc)).to(out_dtype)


def covariance_gram(x: torch.Tensor, acc_dtype: torch.dtype = torch.float32,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Gram matrix C = x^T x over the sample axis (-2) in ``acc_dtype``.
    Operands are widened to the accumulator first: a product of two bf16
    values is exact in float32, as it is in the kernel."""
    out_dtype = out_dtype or acc_dtype
    xa = x.to(acc_dtype)
    return torch.matmul(xa.mT, xa).to(out_dtype)


def jacobi_sweep_step(C: torch.Tensor, V: torch.Tensor, pairs: torch.Tensor,
                      angle: str = "rutishauser"):
    """One pivot round: gather apq/app/aqq for the (k, 2) disjoint ``pairs``
    -> angle -> null-pivot guard -> rotate the rows, then the columns of C,
    and the columns of V.  ``pairs`` is shared across any batch dims."""
    from repro_torch.core.cordic import ANGLE_MODES
    from repro_torch.core.jacobi import (_apply_rotations_rowcol,
                                         _null_pivot_guard)
    pairs = pairs.to(device=C.device, dtype=torch.long)
    p = pairs[:, 0]
    q = pairs[:, 1]
    apq = C[..., p, q]
    app = C[..., p, p]
    aqq = C[..., q, q]
    _, c, s = ANGLE_MODES[angle](apq, app, aqq)
    c, s = _null_pivot_guard(p, q, apq, c, s)
    c = c.to(C.dtype)
    s = s.to(C.dtype)
    return _apply_rotations_rowcol(C, V, p, q, c, s)
