"""Mixed-precision policy for the PCA hot path (port of
``repro.core.precision``).

  ``fp32``          fp32 operands, fp32 accumulation (the default).
  ``bf16_fp32acc``  bf16 operand streaming into fp32 accumulators for the
                    covariance/Gram products; rotations, angles and the
                    U = A V back-projection stay fp32.
  ``fp64``          the reference lane: native ``torch.float64`` (on the CPU;
                    the CUDA kernels take fp32/bf16 operands only).  The
                    reference reaches it through a ``JAX_ENABLE_X64=1``
                    subprocess (``supports_x64``, ``run_fp64_oracle``);
                    the port needs neither: its entry points take floating
                    input as float64 under this policy.

``ERROR_BUDGETS`` is the relative-Frobenius-error ceiling of each
(policy, op) against a float64 reference; the numbers are the reference's
(the Gram's ``||C - C64|| / ||C64||``, the eigenvalue and singular-value
vectors' errors).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

PRECISIONS = ("fp32", "bf16_fp32acc", "fp64")

ERROR_BUDGETS: Dict[str, Dict[str, float]] = {
    "fp32": {"covariance": 1e-5, "eigh": 1e-4, "svd": 1e-4},
    "bf16_fp32acc": {"covariance": 2e-2, "eigh": 2e-2, "svd": 2e-2},
    "fp64": {"covariance": 0.0, "eigh": 0.0, "svd": 0.0},
}


def validate(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    return precision


def operand_dtype(precision: str) -> torch.dtype:
    """The dtype operands stream at under a policy."""
    validate(precision)
    if precision == "bf16_fp32acc":
        return torch.bfloat16
    if precision == "fp64":
        return torch.float64
    return torch.float32


def acc_dtype(precision: str) -> torch.dtype:
    """The accumulator dtype -- never narrower than fp32."""
    validate(precision)
    return torch.float64 if precision == "fp64" else torch.float32



def rel_frobenius(a, b) -> float:
    """||a - b||_F / ||b||_F (b is the reference), in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    denom = max(float(np.linalg.norm(b)), 1e-30)
    return float(np.linalg.norm(a - b)) / denom
