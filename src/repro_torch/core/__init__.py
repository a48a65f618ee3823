"""Core PCA/SVD engine of the port (mirrors ``repro.core``)."""
from .covariance import (blocked_covariance, covariance,
                         distributed_covariance, standardize)
from .jacobi import (DEFAULT_SWEEPS, EighResult, cyclic_pairs, jacobi_eigh,
                     jacobi_svd, offdiag_frobenius, relative_offdiag,
                     round_robin_rounds)
from .pca import (PAPER_CONFIG_ARTIX7, PAPER_CONFIG_VUS, PCAConfig,
                  PCAResult, evcr_cvcr, fit, fit_distributed,
                  fit_transform, select_k, transform)
from .schedule import (PAPER_SCHEDULE, SweepSchedule, convergence_curve,
                       make_ill_conditioned, sweeps_to_tolerance)
from . import memory_model

__all__ = ["blocked_covariance", "covariance", "distributed_covariance",
           "standardize",
           "DEFAULT_SWEEPS", "EighResult", "cyclic_pairs", "jacobi_eigh",
           "jacobi_svd", "offdiag_frobenius", "relative_offdiag",
           "round_robin_rounds", "PAPER_CONFIG_ARTIX7", "PAPER_CONFIG_VUS",
           "PCAConfig", "PCAResult", "evcr_cvcr", "fit", "fit_distributed",
           "fit_transform",
           "select_k", "transform", "PAPER_SCHEDULE", "SweepSchedule",
           "convergence_curve", "make_ill_conditioned",
           "sweeps_to_tolerance", "memory_model"]
