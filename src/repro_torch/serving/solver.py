"""Batched PCA/SVD solvers (port of ``repro.serving.solver``): the paper's
S-array axis as a leading batch dimension.

The reference ``vmap``s the single-problem solve; here the batch is written
out: one (B, nb, nb) tensor goes through every pivot round at once (one
kernel launch per sweep under ``fused=True``), with the (k, 2) pivot pairs
of each round shared by the whole bucket.

Bucket-padding contract: inputs arrive zero-padded into a shared bucket
(``serving.batching``) with per-problem true sizes ``n_active``.  The
null-pivot guard in ``core.jacobi`` makes every rotation that touches a
padded coordinate the exact identity, so the padded block of C stays
exactly zero and the eigenvector columns of padded coordinates stay exact
basis vectors; ``_masked_sort`` then recovers each embedded problem's
descending eigenpairs with a reorder.

Every entry point takes ``device=``: numpy input goes there (default
``cuda``); a tensor keeps its own device.  Floating input is taken as
float32 (bfloat16 kept), or as float64 under ``precision="fp64"``
(``_device.as_input``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .._device import DeviceLike, as_input
from ..core.jacobi import DEFAULT_SWEEPS, _check_modes, _solve
from ..core.pca import PCAConfig, evcr_cvcr


class BatchedEighResult(NamedTuple):
    eigenvalues: torch.Tensor   # (B, nb) descending per problem, padded tail 0
    eigenvectors: torch.Tensor  # (B, nb, nb) columns pair with eigenvalues
    off_norm: torch.Tensor      # (B,) final relative off-diagonal norms
    n_active: torch.Tensor      # (B,) true problem sizes


class BatchedSVDResult(NamedTuple):
    U: torch.Tensor             # (B, mb, nb)
    S: torch.Tensor             # (B, nb) descending, padded tail 0
    Vt: torch.Tensor            # (B, nb, nb)
    n_rows: torch.Tensor        # (B,)
    n_cols: torch.Tensor        # (B,)


class BatchedPCAResult(NamedTuple):
    components: torch.Tensor    # (B, nb, nb) eigenvector columns, descending
    eigenvalues: torch.Tensor   # (B, nb)
    mean: torch.Tensor          # (B, nb)
    scale: torch.Tensor         # (B, nb)
    evcr: torch.Tensor          # (B, nb)
    cvcr: torch.Tensor          # (B, nb)
    off_norm: torch.Tensor      # (B,)
    n_rows: torch.Tensor        # (B,)
    n_cols: torch.Tensor        # (B,)


def _as_n_active(n_active, batch: int, full: int,
                 device: torch.device) -> torch.Tensor:
    if n_active is None:
        return torch.full((batch,), full, dtype=torch.int32, device=device)
    if isinstance(n_active, torch.Tensor):
        return n_active.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(n_active, np.int32), device=device)


def _check_batch(x: torch.Tensor, what: str) -> None:
    if x.ndim != 3:
        raise ValueError(f"expected (B, {what}) batch, got shape "
                         f"{tuple(x.shape)}")


def _masked_sort(w, V, n_active):
    """Descending sort of the *live* eigenpairs of each problem; padded
    pairs go last, in their original order.  Padded coordinates hold exact
    zero eigenvalues, which would interleave with a mixed-sign live
    spectrum under a plain sort, so they are scored at -inf."""
    nb = w.shape[-1]
    live = torch.arange(nb, device=w.device)[None, :] < n_active[:, None]
    score = torch.where(live, w, torch.full_like(w, -torch.inf))
    # stable, as jnp.argsort: ties and the padded tail keep their order
    order = torch.argsort(-score, dim=-1, stable=True)
    w = torch.where(live, torch.gather(w, -1, order), torch.zeros_like(w))
    V = torch.gather(V, -1, order[:, None, :].expand_as(V))
    return w, V


def jacobi_eigh_batched(
    C,
    n_active=None,
    sweeps: int = DEFAULT_SWEEPS,
    pivot: str = "parallel",
    rotation: str = "rowcol",
    angle: str = "rutishauser",
    matmul_fn: Optional[Callable] = None,
    tol: Optional[float] = None,
    sort: bool = True,
    fused: bool = False,
    fused_backend: Optional[str] = None,
    precision: str = "fp32",
    device: DeviceLike = None,
) -> BatchedEighResult:
    """Batched symmetric eigendecomposition over a shape bucket.

    C: (B, nb, nb) zero-padded symmetric matrices; ``n_active``: (B,) true
    sizes (None = all full), rows/cols >= n_active[i] zero.  The other
    arguments are those of ``core.jacobi.jacobi_eigh``; with ``tol`` each
    problem stops at its own sweep.
    """
    C = as_input(C, device, precision)
    _check_batch(C, "n, n")
    _check_modes(pivot, rotation)
    n_active = _as_n_active(n_active, C.shape[0], C.shape[-1], C.device)
    if C.shape[-1] == 1:  # trivial 1x1 problems
        w = torch.diagonal(C, dim1=-2, dim2=-1)
        V = torch.ones_like(C)
        off = torch.zeros(C.shape[0], dtype=C.dtype, device=C.device)
    else:
        w, V, off, _ = _solve(C, sweeps, pivot, rotation, angle, matmul_fn,
                              tol, False, fused, fused_backend)
    if sort:
        w, V = _masked_sort(w, V, n_active)
    return BatchedEighResult(w, V, off, n_active)


def jacobi_svd_batched(
    A,
    n_rows=None,
    n_cols=None,
    matmul_fn: Optional[Callable] = None,
    rcond: Optional[float] = None,
    fused: bool = False,
    fused_backend: Optional[str] = None,
    precision: str = "fp32",
    device: DeviceLike = None,
    **eigh_kwargs,
) -> BatchedSVDResult:
    """Batched thin SVD via the Gram-matrix path.

    A: (B, mb, nb) zero-padded.  The Gram, the rotations and U = A V share
    ``matmul_fn``; ``fused`` routes the Gram through the ``covariance`` op
    and the sweeps through ``jacobi_sweep``.  Columns whose singular value
    falls below ``rcond * s_max`` (default sqrt(nb * eps_f32)) get an exact
    zero U column: the Gram path cannot resolve them, and U = A V / s would
    amplify rounding noise there.
    """
    A = as_input(A, device, precision)
    _check_batch(A, "m, n")
    B, mb, nb = A.shape
    n_rows = _as_n_active(n_rows, B, mb, A.device)
    n_cols = _as_n_active(n_cols, B, nb, A.device)
    mm = matmul_fn or torch.matmul
    if fused:
        from repro_torch.kernels import ops as kops
        gram = kops.covariance(A, precision=precision, backend=fused_backend)
    else:
        gram = mm(A.mT, A)
    res = jacobi_eigh_batched(gram, n_active=n_cols, matmul_fn=matmul_fn,
                              fused=fused, fused_backend=fused_backend,
                              precision=precision, **eigh_kwargs)
    s = torch.sqrt(res.eigenvalues.clamp_min(0.0))
    safe = s.clamp_min(1e-30)
    if rcond is None:
        rcond = float(np.sqrt(nb * np.finfo(np.float32).eps))
    # relative cutoff per problem; an all-zero problem (s_max == 0) has no
    # live column and U comes out exactly zero
    cutoff = rcond * torch.amax(s, dim=-1, keepdim=True)
    live = s > cutoff
    U = mm(A, res.eigenvectors) / safe[:, None, :]
    U = torch.where(live[:, None, :], U, torch.zeros_like(U))
    Vt = res.eigenvectors.mT
    return BatchedSVDResult(U, s, Vt, n_rows, n_cols)


def _masked_standardize(X, m, d, eps: float = 1e-8):
    """Per-feature zero-mean / unit-variance over each problem's live
    (m, d) block of X (B, mb, db).  Padded rows must not bias the moments
    and padded entries stay exactly zero (X - mean is nonzero on padded
    rows), so both masks are applied.  Matches ``core.covariance.
    standardize`` (population std) on an exact fit."""
    B, mb, db = X.shape
    rmask = (torch.arange(mb, device=X.device)[None, :]
             < m[:, None]).to(X.dtype)[..., None]
    cmask = (torch.arange(db, device=X.device)[None, :]
             < d[:, None]).to(X.dtype)
    cnt = m.clamp_min(1).to(X.dtype)[:, None]
    mean = torch.sum(X * rmask, dim=1) / cnt
    diff = (X - mean[:, None, :]) * rmask
    var = torch.sum(diff * diff, dim=1) / cnt
    std = torch.sqrt(var)
    std = torch.where(std < eps, torch.ones_like(std), std)
    return (diff / std[:, None, :]) * cmask[:, None, :], mean * cmask, std


def pca_fit_batched(
    X,
    n_rows=None,
    n_cols=None,
    config: PCAConfig = PCAConfig(),
    device: DeviceLike = None,
) -> BatchedPCAResult:
    """Batched PCA fit (paper Alg. 1 across the S axis).

    X: (B, mb, db) zero-padded data matrices sharing one bucket, with true
    shapes in (n_rows, n_cols).  EVCR/CVCR cover the live spectrum only
    (padded eigenvalues are exactly zero)."""
    X = as_input(X, device, config.precision)
    _check_batch(X, "m, d")
    B, mb, db = X.shape
    n_rows = _as_n_active(n_rows, B, mb, X.device)
    n_cols = _as_n_active(n_cols, B, db, X.device)
    mm = config.matmul_fn() or torch.matmul

    if config.standardize:
        Xs, mean, scale = _masked_standardize(X, n_rows, n_cols)
    else:
        Xs = X
        mean = torch.zeros((B, db), dtype=X.dtype, device=X.device)
        scale = torch.ones((B, db), dtype=X.dtype, device=X.device)
    if config.fused:
        from repro_torch.kernels import ops as kops
        C = kops.covariance(Xs, precision=config.precision,
                            backend=config.backend)
    else:
        C = mm(Xs.mT, Xs)
    res = jacobi_eigh_batched(
        C, n_active=n_cols, sweeps=config.sweeps, pivot=config.pivot,
        rotation=config.rotation, angle=config.angle,
        matmul_fn=config.matmul_fn(), tol=config.tol,
        fused=config.fused, fused_backend=config.backend,
        precision=config.precision)
    evcr, cvcr = evcr_cvcr(res.eigenvalues)
    return BatchedPCAResult(res.eigenvectors, res.eigenvalues, mean, scale,
                            evcr, cvcr, res.off_norm, n_rows, n_cols)


def build_solver_fn(op: str, config: PCAConfig,
                    device: DeviceLike = None) -> Callable:
    """The batched solver for one op under one config, with the uniform
    signature ``(batch, n_rows, n_cols) -> result`` (eigh ignores the
    column counts: a square bucket's two n_active axes coincide)."""
    kw = dict(sweeps=config.sweeps, pivot=config.pivot,
              rotation=config.rotation, angle=config.angle, tol=config.tol,
              matmul_fn=config.matmul_fn(),
              fused=config.fused, fused_backend=config.backend,
              precision=config.precision, device=device)
    if op == "eigh":
        return lambda C, nr, nc: jacobi_eigh_batched(C, nr, **kw)
    if op == "svd":
        return lambda A, nr, nc: jacobi_svd_batched(A, nr, nc, **kw)
    if op == "pca":
        return lambda X, nr, nc: pca_fit_batched(X, nr, nc, config=config,
                                                 device=device)
    raise ValueError(f"unknown op {op!r}")


def pca_transform_batched(X, result: BatchedPCAResult, k: int,
                          matmul_fn: Optional[Callable] = None,
                          device: DeviceLike = None):
    """Batched top-k projection O = X_std V_k (paper eq. 5).  X is taken
    as float64 when the fit was (the fp64 lane), else as float32."""
    mm = matmul_fn or torch.matmul
    X = as_input(X, device, "fp64" if result.mean.dtype == torch.float64
                 else "fp32")
    scale = torch.where(result.scale == 0.0, torch.ones_like(result.scale),
                        result.scale)
    rmask = (torch.arange(X.shape[1], device=X.device)[None, :]
             < result.n_rows[:, None]).to(X.dtype)
    Xs = (X - result.mean[:, None, :]) / scale[:, None, :] * rmask[:, :, None]
    return mm(Xs, result.components[..., :k])
