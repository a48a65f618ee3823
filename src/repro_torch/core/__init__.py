"""Core PCA/SVD engine of the port (mirrors ``repro.core``)."""
from .covariance import blocked_covariance, covariance, standardize
from .jacobi import (DEFAULT_SWEEPS, EighResult, cyclic_pairs, jacobi_eigh,
                     jacobi_svd, offdiag_frobenius, relative_offdiag,
                     round_robin_rounds)
from .pca import (PAPER_CONFIG_ARTIX7, PAPER_CONFIG_VUS, PCAConfig,
                  PCAResult, evcr_cvcr, fit, fit_transform, select_k,
                  transform)

__all__ = ["blocked_covariance", "covariance", "standardize",
           "DEFAULT_SWEEPS", "EighResult", "cyclic_pairs", "jacobi_eigh",
           "jacobi_svd", "offdiag_frobenius", "relative_offdiag",
           "round_robin_rounds", "PAPER_CONFIG_ARTIX7", "PAPER_CONFIG_VUS",
           "PCAConfig", "PCAResult", "evcr_cvcr", "fit", "fit_transform",
           "select_k", "transform"]
