"""End-to-end PCA pipeline (port of ``repro.core.pca``; paper Alg. 1).

standardize -> C = X^T X (block-streamed) -> Jacobi eigh -> EVCR/CVCR
top-k selection -> projection O = X V_k.

``PCAConfig.backend`` names the kernel backend of the matmul datapath:
None = plain ``torch.matmul``; ``"cuda"`` (the counterpart of the
reference's ``"pallas"``) or ``"torch"`` routes every matmul through the
``mm_engine_matmul`` op, and the fused ops (``fused=True``) through the
same backend.  ``fit_distributed`` is the data-parallel fit over a device
mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from .._device import DeviceLike, as_input
from ..obs.tracing import stage
from .covariance import (blocked_covariance, distributed_covariance,
                         standardize)
from .jacobi import DEFAULT_SWEEPS, EighResult, jacobi_eigh


@dataclasses.dataclass(frozen=True)
class PCAConfig:
    T: int = 128                  # tile size (paper T; streaming block)
    S: int = 8                    # parallelism index (paper S)
    sweeps: int = DEFAULT_SWEEPS  # fixed deterministic schedule
    tol: Optional[float] = None   # software early exit (None = hardware mode)
    pivot: str = "parallel"       # "paper" | "cyclic" | "parallel"
    rotation: str = "rowcol"      # "matmul" = unified MM-Engine datapath
    angle: str = "rutishauser"    # "cordic" = paper-faithful datapath
    standardize: bool = True
    # kernel backend for the matmul datapath and the fused ops: None =
    # plain torch.matmul (fused ops follow the tensor's device); "cuda" /
    # "torch" = the registry backend (repro_torch.backends)
    backend: Optional[str] = None
    # precision policy of the covariance/Gram leg (repro_torch.core.precision)
    precision: str = "fp32"
    # route the hot path through the fused ops (covariance + jacobi_sweep).
    # Against fused=False at fp32: on the CPU the Gram and the fit are
    # bitwise equal (the plain Gram sums the same T-row panels in order);
    # the CUDA Gram sums in another order and is held to relative
    # Frobenius 1e-6 of the unfused Gram (ERROR_BUDGETS["fp32"] allows
    # 1e-5); the CUDA sweep is bitwise its plain version.
    fused: bool = False

    def matmul_fn(self) -> Optional[Callable]:
        if self.backend is None:
            return None
        from repro_torch.kernels import ops as kops
        backend = self.backend
        return lambda a, b: kops.mm_engine_matmul(a, b, block=self.T,
                                                  backend=backend)


PAPER_CONFIG_ARTIX7 = PCAConfig(T=4, S=8)
PAPER_CONFIG_VUS = PCAConfig(T=16, S=32)


class PCAResult(NamedTuple):
    components: torch.Tensor   # (d, d) eigenvectors, columns, descending
    eigenvalues: torch.Tensor  # (d,) descending
    mean: torch.Tensor
    scale: torch.Tensor
    evcr: torch.Tensor         # explained variance contribution ratio (eq. 3)
    cvcr: torch.Tensor         # cumulative variance contribution ratio (eq. 4)
    off_norm: torch.Tensor     # final relative off-diagonal norm


def evcr_cvcr(eigenvalues):
    lam = eigenvalues.clamp_min(0.0)
    total = torch.sum(lam, dim=-1, keepdim=True).clamp_min(1e-30)
    evcr = lam / total
    cvcr = torch.cumsum(evcr, dim=-1)
    return evcr, cvcr


def select_k(cvcr, variance_target: float = 0.95) -> torch.Tensor:
    """Smallest k whose CVCR reaches the target (scree-plot companion)."""
    return torch.clamp(torch.sum(cvcr < variance_target, dim=-1) + 1,
                       max=cvcr.shape[-1])


def fit(X, config: PCAConfig = PCAConfig(),
        device: DeviceLike = None) -> PCAResult:
    """Fit PCA on one (m, d) data matrix.  Numpy input goes to ``device``
    (default ``cuda``); a tensor keeps its own device.  Floating input is
    taken as float32 (bfloat16 kept), or as float64 under
    ``precision="fp64"`` (``_device.as_input``)."""
    X = as_input(X, device, config.precision)
    with stage("repro.fit.standardize"):
        if config.standardize:
            Xs, mean, scale = standardize(X)
        else:
            Xs = X
            mean = torch.zeros((X.shape[1],), dtype=X.dtype, device=X.device)
            scale = torch.ones((X.shape[1],), dtype=X.dtype, device=X.device)
    mm = config.matmul_fn()
    with stage("repro.fit.covariance"):
        C = blocked_covariance(Xs, block_m=config.T, matmul_fn=mm,
                               fused=config.fused,
                               precision=config.precision,
                               backend=config.backend)
    with stage("repro.fit.eigh"):
        res: EighResult = jacobi_eigh(
            C,
            sweeps=config.sweeps,
            tol=config.tol,
            pivot=config.pivot,
            rotation=config.rotation,
            angle=config.angle,
            matmul_fn=mm,
            fused=config.fused,
            fused_backend=config.backend,
            precision=config.precision,
        )
        evcr, cvcr = evcr_cvcr(res.eigenvalues)
    return PCAResult(res.eigenvectors, res.eigenvalues, mean, scale, evcr,
                     cvcr, res.off_norm)


def transform(X, result: PCAResult, k: int, config: PCAConfig = PCAConfig(),
              device: DeviceLike = None):
    """Project onto the top-k subspace: O = X_std V_k (paper eq. 5)."""
    with stage("repro.fit.transform"):
        Xs = ((as_input(X, device, config.precision) - result.mean)
              / result.scale)
        mm = config.matmul_fn() or torch.matmul
        return mm(Xs, result.components[:, :k])


def fit_transform(X, k: int, config: PCAConfig = PCAConfig(),
                  device: DeviceLike = None):
    """``fit`` then ``transform`` of one (m, d) X: (the (m, k) projection,
    the fit).  Under a profiler the call is a ``repro.fit`` range over the
    four stages' ranges, ``repro.fit.standardize``, ``.covariance``,
    ``.eigh`` and ``.transform``."""
    with stage("repro.fit"):
        X = as_input(X, device, config.precision)
        res = fit(X, config)
        return transform(X, res, k, config), res


def fit_distributed(X, mesh, config: PCAConfig = PCAConfig(),
                    data_axis: str = "data") -> PCAResult:
    """Data-parallel PCA over ``mesh`` (a ``parallel.sharding.Mesh``): the
    covariance block-streamed across the mesh (each data shard one
    row-block group of the paper's schedule, ``block_m=config.T``), Jacobi
    on the d x d covariance on the mesh's first device.

    As in the reference, ``config.fused``, ``config.backend`` and
    ``config.precision`` are ignored: the Gram streams through
    ``torch.matmul`` and the solve is the unfused Jacobi, whatever the
    config says.  Numpy input, and a tensor elsewhere, goes to the mesh's
    first device, where the whole X is standardized before it is split.
    """
    X = as_input(X, mesh.devices.flat[0])
    if config.standardize:
        Xs, mean, scale = standardize(X)
    else:
        Xs = X
        mean = torch.zeros((X.shape[1],), device=X.device)
        scale = torch.ones((X.shape[1],), device=X.device)
    C = distributed_covariance(Xs, mesh, data_axis=data_axis,
                               block_m=config.T)
    res = jacobi_eigh(C, sweeps=config.sweeps, tol=config.tol,
                      pivot=config.pivot, rotation=config.rotation,
                      angle=config.angle)
    evcr, cvcr = evcr_cvcr(res.eigenvalues)
    return PCAResult(res.eigenvectors, res.eigenvalues, mean, scale, evcr,
                     cvcr, res.off_norm)
