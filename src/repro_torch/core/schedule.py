"""Deterministic sweep scheduling and the Frobenius-norm convergence study
(port of ``repro.core.schedule``).

The paper replaces on-chip convergence monitoring with an offline
Frobenius-norm study that fixes a 50-sweep schedule (Sec. V, Sec. VII-D).
This module is that offline study, plus the schedule object the solvers
consume.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .._device import DeviceLike, as_input
from .covariance import covariance, standardize
from .jacobi import DEFAULT_SWEEPS, jacobi_eigh


@dataclasses.dataclass(frozen=True)
class SweepSchedule:
    """Fixed-iteration schedule (hardware mode) or tolerance mode (software).

    ``sweeps`` is the deterministic upper bound; ``tol=None`` reproduces the
    hardware's fixed-latency behaviour.
    """
    sweeps: int = DEFAULT_SWEEPS
    tol: Optional[float] = None

    def kwargs(self) -> Dict:
        return {"sweeps": self.sweeps, "tol": self.tol}


PAPER_SCHEDULE = SweepSchedule(sweeps=DEFAULT_SWEEPS, tol=None)


def convergence_curve(
    X,
    sweeps: int = 25,
    pivot: str = "parallel",
    angle: str = "rutishauser",
    device: DeviceLike = None,
) -> np.ndarray:
    """Relative off-diagonal energy after each sweep (paper Fig. 8), in
    float32 whatever X's dtype.  Returns an array of length sweeps+1
    (index 0 = before any sweep).  Numpy X goes to ``device`` (default
    ``cuda``)."""
    Xs, _, _ = standardize(as_input(X, device))
    C = covariance(Xs)
    res = jacobi_eigh(C, sweeps=sweeps, pivot=pivot, angle=angle,
                      track_history=True)
    return res.history.cpu().numpy()


def sweeps_to_tolerance(curve: np.ndarray, tol: float = 1e-6) -> int:
    """First sweep index at which the relative off-norm drops below tol
    (returns len(curve) if never)."""
    below = np.nonzero(curve <= tol)[0]
    return int(below[0]) if below.size else len(curve)


def make_ill_conditioned(n: int, d: int, cluster_gap: float = 1e-6,
                         seed: int = 0) -> np.ndarray:
    """Synthetic dataset with tightly clustered eigenvalues -- the
    ill-conditioned regime the 50-sweep safety factor is sized for."""
    rng = np.random.default_rng(seed)
    # eigenvalues clustered in pairs separated by cluster_gap
    base = np.repeat(np.linspace(1.0, 2.0, d // 2 + 1)[: (d + 1) // 2], 2)[:d]
    eigs = base + cluster_gap * rng.standard_normal(d)
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    cov_sqrt = Q * np.sqrt(np.abs(eigs))
    return (rng.standard_normal((n, d)) @ cov_sqrt.T).astype(np.float32)
