"""Jacobi eigendecomposition engine (port of ``repro.core.jacobi``).

Pivot strategies ``"paper"`` (max-pivot via the DLE), ``"cyclic"``
(row-cyclic, one pivot per round) and ``"parallel"`` (round-robin
tournament, n/2 disjoint pivots per round, n-1 rounds per sweep); rotation
modes ``"rowcol"`` (touched rows/columns only) and ``"matmul"``
(C <- J^T C J, V <- V J through the injected matmul).

Every function here takes one matrix (n, n) or a batch (B, n, n): the
batch is a leading dimension written out, and ``lax.scan``/``fori_loop``
become Python loops over rounds (under ``fused=True``, one op call and one
kernel launch per sweep instead).  The public single-problem entry point is
``jacobi_eigh``; ``serving.solver.jacobi_eigh_batched`` drives the same
``_solve`` over a bucket.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .._device import DeviceLike, as_input
from . import dle as dle_mod
from . import precision as prec
from .cordic import ANGLE_MODES

DEFAULT_SWEEPS = 50  # paper Sec. VII-D: fixed 50-sweep factor of safety

_CAPTURE = threading.local()


@contextlib.contextmanager
def capture_form():
    """Solve in the form a CUDA graph can hold: no host sync.  Under
    ``tol`` every sweep then runs under the per-problem masks, without the
    early ``break`` once all problems converged -- bitwise the early-exit
    solve, because a finished problem keeps its (C, V) and so stays
    finished.  ``serving.sharded`` captures its graphs in this form."""
    before = getattr(_CAPTURE, "on", False)
    _CAPTURE.on = True
    try:
        yield
    finally:
        _CAPTURE.on = before


class EighResult(NamedTuple):
    eigenvalues: torch.Tensor    # (..., n) descending
    eigenvectors: torch.Tensor   # (..., n, n), column i pairs with value i
    off_norm: torch.Tensor       # (...) final relative off-diagonal norm
    history: Optional[torch.Tensor]  # (sweeps+1, ...) off-norm per sweep


def offdiag_frobenius(C):
    """E_off(A) = sqrt(sum_{i != j} a_ij^2)  (paper eq. 11)."""
    n = C.shape[-1]
    off = C * (1.0 - torch.eye(n, dtype=C.dtype, device=C.device))
    return torch.sqrt(torch.sum(off * off, dim=(-2, -1)))


def relative_offdiag(C):
    total = torch.sqrt(torch.sum(C * C, dim=(-2, -1)))
    return offdiag_frobenius(C) / total.clamp_min(1e-30)


@functools.lru_cache(maxsize=64)
def round_robin_rounds(n: int) -> np.ndarray:
    """(n-1, n//2, 2) disjoint pivot pairs per round (circle method).

    ``n`` must be even; every unordered pair appears exactly once per sweep.
    """
    if n % 2:
        raise ValueError("round-robin ordering needs even n (pad first)")
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        pairs = []
        for i in range(n // 2):
            a, b = players[i], players[n - 1 - i]
            pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.asarray(rounds, dtype=np.int32)


@functools.lru_cache(maxsize=64)
def cyclic_pairs(n: int) -> np.ndarray:
    """(n(n-1)/2, 1, 2) row-cyclic pivot order."""
    pairs = [(p, q) for p in range(n - 1) for q in range(p + 1, n)]
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 1, 2)


@functools.lru_cache(maxsize=64)
def pair_table(pivot: str, n: int, device: torch.device) -> torch.Tensor:
    """The (R, k, 2) int32 pivot pairs of one sweep of the ``"parallel"``
    or ``"cyclic"`` schedule at even-padded size n, on ``device``: one copy
    a (pivot, n, device), so a solve copies nothing to the card.  The copy
    to a card goes through pinned memory without blocking the host (a
    pageable copy would wait for every launch queued before it)."""
    table = torch.from_numpy(round_robin_rounds(n) if pivot == "parallel"
                             else cyclic_pairs(n))
    if device.type != "cuda":
        return table.to(device)
    return table.pin_memory().to(device, non_blocking=True)


def _batch_index(idx, C, k):
    """Broadcast (k,) or (..., k) pivot indices to C's batch shape."""
    return idx.expand(*C.shape[:-2], k)


def _build_rotation(C, p, q, c, s):
    """Dense block rotation J (identity + embedded 2x2s, paper eq. 7) with
    C's shape.  A degenerate pivot p == q (the DLE's answer on an already
    diagonal matrix) carries c = 1, s = 0 from ``_null_pivot_guard``; its
    off-diagonal writes land on the diagonal as c instead of zeroing it."""
    n = C.shape[-1]
    k = p.shape[-1]
    p = _batch_index(p, C, k)
    q = _batch_index(q, C, k)
    c = c.to(C.dtype)
    s = s.to(C.dtype)
    eye = torch.eye(n, dtype=C.dtype, device=C.device)
    J = eye.expand(C.shape).reshape(*C.shape[:-2], n * n).clone()
    same = p == q
    for i, j, val in ((p, p, c), (q, q, c),
                      (p, q, torch.where(same, c, s)),
                      (q, p, torch.where(same, c, -s))):
        J = J.scatter(-1, i * n + j, val)
    return J.reshape(C.shape)


def _null_pivot_guard(p, q, apq, c, s):
    """Force the exact identity rotation on null pivots: apq == 0 (nothing
    to annihilate; atan2/CORDIC would leave a nonzero angle) or p == q.
    This is what keeps zero-padded coordinates exactly zero."""
    null = (apq == 0.0) | (p == q)
    c = torch.where(null, torch.ones_like(c), c)
    s = torch.where(null, torch.zeros_like(s), s)
    return c, s


def _apply_rotations_rowcol(C, V, p, q, c, s):
    """Apply commuting rotations for disjoint pivot sets.

    Convention (paper R, eq. 7): R[p,p]=R[q,q]=c, R[p,q]=s, R[q,p]=-s;
    C' = R^T C R (rows first, then columns), V' = V R.  ``p``/``q`` are
    (k,) shared or (..., k) per problem; ``c``/``s`` are (..., k).
    """
    n = C.shape[-1]
    k = p.shape[-1]
    batch = C.shape[:-2]
    p = _batch_index(p, C, k)
    q = _batch_index(q, C, k)
    ip = p[..., :, None].expand(*batch, k, n)
    iq = q[..., :, None].expand(*batch, k, n)
    c_ = c[..., :, None]
    s_ = s[..., :, None]
    rows_p = C.gather(-2, ip)
    rows_q = C.gather(-2, iq)
    C = C.scatter(-2, ip, c_ * rows_p - s_ * rows_q)
    C = C.scatter(-2, iq, s_ * rows_p + c_ * rows_q)
    jp = p[..., None, :].expand(*batch, n, k)
    jq = q[..., None, :].expand(*batch, n, k)
    c2 = c[..., None, :]
    s2 = s[..., None, :]
    cols_p = C.gather(-1, jp)
    cols_q = C.gather(-1, jq)
    C = C.scatter(-1, jp, c2 * cols_p - s2 * cols_q)
    C = C.scatter(-1, jq, s2 * cols_p + c2 * cols_q)
    vp = V.gather(-1, jp)
    vq = V.gather(-1, jq)
    V = V.scatter(-1, jp, c2 * vp - s2 * vq)
    V = V.scatter(-1, jq, s2 * vp + c2 * vq)
    return C, V


def _apply_rotations_matmul(C, V, p, q, c, s, matmul_fn):
    J = _build_rotation(C, p, q, c, s)
    C = matmul_fn(matmul_fn(J.mT, C), J)
    V = matmul_fn(V, J)
    return C, V


def _sweep_scan(C, V, rounds, angle_fn, rotation, matmul_fn,
                fused: bool = False, angle: str = "rutishauser",
                fused_backend: Optional[str] = None):
    """One full sweep over the pivot rounds (``rounds`` is the (R, k, 2)
    int32 tensor on C's device).

    ``fused`` hands all R rounds to one call of the ``jacobi_sweep`` op --
    gather + angle + guard + row/col rotation, one kernel launch a sweep
    on the card -- for ``rotation="rowcol"`` (the "matmul" datapath stays
    unfused, as in the reference).  The op works out of place: the
    caller's C and V are never written.  Unfused, the rounds are a Python
    loop.
    """
    if fused and rotation == "rowcol":
        from repro_torch.kernels import ops as kops
        if rounds.shape[0] == 0:
            return C, V
        return kops.jacobi_sweep(C, V, rounds, angle=angle,
                                 backend=fused_backend)
    long_rounds = rounds.long()
    for pairs in long_rounds:
        p = pairs[:, 0]
        q = pairs[:, 1]
        apq = C[..., p, q]
        app = C[..., p, p]
        aqq = C[..., q, q]
        _, c, s = angle_fn(apq, app, aqq)
        c, s = _null_pivot_guard(p, q, apq, c, s)
        c = c.to(C.dtype)
        s = s.to(C.dtype)
        if rotation == "rowcol":
            C, V = _apply_rotations_rowcol(C, V, p, q, c, s)
        else:
            C, V = _apply_rotations_matmul(C, V, p, q, c, s, matmul_fn)
    return C, V


def _max_pivot_sweep(C, V, n_rot: int, angle_fn, rotation, matmul_fn,
                     pivot_fn=dle_mod.find_pivot):
    """n_rot classical max-pivot rotations (DLE lookup per rotation)."""
    for _ in range(n_rot):
        piv = pivot_fn(C)
        _, c, s = angle_fn(piv.apq, piv.app, piv.aqq)
        c, s = _null_pivot_guard(piv.p, piv.q, piv.apq, c, s)
        c = c.to(C.dtype)[..., None]
        s = s.to(C.dtype)[..., None]
        p = piv.p[..., None]
        q = piv.q[..., None]
        if rotation == "rowcol":
            C, V = _apply_rotations_rowcol(C, V, p, q, c, s)
        else:
            C, V = _apply_rotations_matmul(C, V, p, q, c, s, matmul_fn)
    return C, V


def _check_modes(pivot: str, rotation: str):
    if pivot not in ("parallel", "cyclic", "paper"):
        raise ValueError(f"unknown pivot strategy {pivot!r}")
    if rotation not in ("rowcol", "matmul"):
        raise ValueError(f"unknown rotation mode {rotation!r}")


def _solve(C, sweeps, pivot, rotation, angle, matmul_fn, tol,
           track_history, fused, fused_backend):
    """Unsorted Jacobi solve of C (..., n, n), n >= 2.  Returns
    (eigvals, V, off, history) with odd-n padding already removed."""
    angle_fn = ANGLE_MODES[angle]
    matmul_fn = matmul_fn or torch.matmul
    n_in = C.shape[-1]
    # round-robin needs even n: zero-pad one row/col (exact: the padded
    # coordinate's pivots have apq = 0 -> the guard makes them identities)
    padded = pivot == "parallel" and n_in % 2 == 1
    if padded:
        C = torch.nn.functional.pad(C, (0, 1, 0, 1))
    C = C.contiguous()
    n = C.shape[-1]
    V = torch.eye(n, dtype=C.dtype, device=C.device).expand(C.shape)
    V = V.contiguous()

    if pivot in ("parallel", "cyclic"):
        rounds = pair_table(pivot, n, C.device)
    else:
        rounds = None
        rot_per_sweep = (n_in * (n_in - 1)) // 2  # one "sweep" worth

    def one_sweep(C, V):
        if pivot == "paper":
            return _max_pivot_sweep(C, V, rot_per_sweep, angle_fn, rotation,
                                    matmul_fn)
        return _sweep_scan(C, V, rounds, angle_fn, rotation, matmul_fn,
                           fused=fused, angle=angle,
                           fused_backend=fused_backend)

    history = None
    if tol is not None:
        # per-problem early exit: a finished problem keeps its (C, V)
        sync = not getattr(_CAPTURE, "on", False)
        for _ in range(sweeps):
            active = relative_offdiag(C) > tol
            if sync and not bool(active.any()):
                break
            Cn, Vn = one_sweep(C, V)
            keep = active[..., None, None]
            C = torch.where(keep, Cn, C)
            V = torch.where(keep, Vn, V)
    else:
        hist = [relative_offdiag(C)] if track_history else None
        for _ in range(sweeps):
            C, V = one_sweep(C, V)
            if hist is not None:
                hist.append(relative_offdiag(C))
        if hist is not None:
            history = torch.stack(hist)

    off = relative_offdiag(C)
    eigvals = torch.diagonal(C, dim1=-2, dim2=-1)
    if padded:
        eigvals = eigvals[..., :n_in]
        V = V[..., :n_in, :n_in]
    return eigvals, V, off, history


def jacobi_eigh(
    C,
    sweeps: int = DEFAULT_SWEEPS,
    pivot: str = "parallel",
    rotation: str = "rowcol",
    angle: str = "rutishauser",
    matmul_fn: Optional[Callable] = None,
    tol: Optional[float] = None,
    track_history: bool = False,
    sort: bool = True,
    fused: bool = False,
    fused_backend: Optional[str] = None,
    precision: str = "fp32",
    device: DeviceLike = None,
) -> EighResult:
    """Symmetric eigendecomposition of one (n, n) matrix via Jacobi
    rotations.

    Args as the reference: ``sweeps`` fixed budget; ``pivot`` "parallel" |
    "cyclic" | "paper"; ``rotation`` "rowcol" | "matmul"; ``angle``
    "rutishauser" | "atan2" | "cordic"; ``matmul_fn`` for the "matmul"
    rotation (default ``torch.matmul``); ``tol`` early-exit relative
    off-norm; ``track_history``; ``fused`` runs each sweep through one call
    of the ``jacobi_sweep`` op (parallel/cyclic with rowcol; "paper" and "matmul"
    stay unfused); ``fused_backend`` names its backend (None follows the
    tensor: the CUDA kernel for a CUDA tensor).  Numpy input goes to
    ``device`` (default ``cuda``); floating input is taken as float32
    unless ``precision="fp64"`` (``_device.as_input``).
    """
    _check_modes(pivot, rotation)
    C = as_input(C, device, prec.validate(precision))
    if C.ndim != 2:
        raise ValueError(f"expected an (n, n) matrix, got shape {C.shape}")
    if C.shape[0] == 1:  # trivial 1x1 problem
        return EighResult(torch.diagonal(C), torch.ones_like(C),
                          torch.zeros((), dtype=C.dtype, device=C.device),
                          None)
    eigvals, V, off, history = _solve(C, sweeps, pivot, rotation, angle,
                                      matmul_fn, tol, track_history, fused,
                                      fused_backend)
    if sort:
        order = torch.argsort(-eigvals, stable=True)
        eigvals = eigvals[order]
        V = V[:, order]
    return EighResult(eigvals, V, off, history)


def jacobi_svd(A, matmul_fn: Optional[Callable] = None,
               fused: bool = False, fused_backend: Optional[str] = None,
               precision: str = "fp32", device: DeviceLike = None,
               **kwargs):
    """SVD of one (m, n) matrix A via the eigendecomposition of A^T A;
    returns (U, S, Vt), thin.  The Gram product and U = A V share the
    injected ``matmul_fn`` with the rotations; ``fused`` routes the Gram
    through the ``covariance`` op (``precision`` = its operand dtype) and
    the sweeps through ``jacobi_sweep``.  Input is taken as in
    ``jacobi_eigh``."""
    A = as_input(A, device, prec.validate(precision))
    mm = matmul_fn or torch.matmul
    if fused:
        from repro_torch.kernels import ops as kops
        gram = kops.covariance(A, precision=precision, backend=fused_backend)
    else:
        gram = mm(A.mT, A)
    res = jacobi_eigh(gram, matmul_fn=matmul_fn, fused=fused,
                      fused_backend=fused_backend, precision=precision,
                      **kwargs)
    s = torch.sqrt(res.eigenvalues.clamp_min(0.0))
    V = res.eigenvectors
    safe = s.clamp_min(1e-30)
    U = mm(A, V) / safe[None, :]
    return U, s, V.mT
