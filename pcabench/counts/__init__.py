"""The yardstick: the H100's peaks, and the operations and bytes that each
kernel and each request needs, counted from its true shapes.

Operations are floating-point operations a problem needs, not what a kernel
happens to execute: a padded bucket's extra rows and columns are never
counted.  Bytes count each input read once and each output written once.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_FP32 = 67e12    # FLOP/s, fp32 on the CUDA cores
PEAK_TF32 = 495e12   # FLOP/s, TF32 on the tensor cores: the highest rate
                     # any fp32-operand path (3xTF32 included) can reach
PEAK_BYTES = 3.35e12  # bytes/s of HBM3
F32 = 4              # bytes of a float32


def gram_flops(m: int, n: int) -> float:
    """C = X^T X of an (m, n) X: its symmetric half with the diagonal,
    n(n+1)/2 entries of m terms, one multiply and one add a term (PERF.md's
    0.643 ms at 70000 x 784 and the fp32 rate)."""
    return float(m) * n * (n + 1)


def gram_bytes(m: int, n: int) -> float:
    """X read once, C written once."""
    return F32 * (float(m) * n + float(n) * n)


def sweep_flops(n: int) -> float:
    """One cyclic Jacobi sweep over an n x n problem: n(n-1)/2 rotations,
    each rotating two rows and two columns of C and two columns of V, six
    operations an element pair (paper Alg. 2): 9 n**3."""
    return 9.0 * n ** 3


def sweep_bytes(n: int) -> float:
    """C and V read once and written once."""
    return 4.0 * F32 * n * n


def projection_flops(m: int, n: int, k: int) -> float:
    """Y = Xs V_k: an (m, n) by (n, k) product."""
    return 2.0 * m * n * k


def projection_bytes(m: int, n: int, k: int) -> float:
    return F32 * (float(m) * n + float(n) * k + float(m) * k)


def standardize_flops(m: int, n: int) -> float:
    """Mean (a sum), population std (subtract, square, sum), then subtract
    and divide: six operations an element."""
    return 6.0 * m * n


def fit_flops(m: int, d: int, k: int, sweeps: int) -> float:
    """``fit_transform``: standardize, the Gram, the sweeps, the projection
    (the paper's Alg. 1)."""
    return (standardize_flops(m, d) + gram_flops(m, d)
            + sweeps * sweep_flops(d) + projection_flops(m, d, k))


def request_flops(op: str, shape, sweeps: int) -> float:
    """One served request at its own size, never its bucket's.  eigh: the
    sweeps; svd: the Gram, the sweeps and U = A V (2 m n**2); pca: the
    standardization, the Gram and the sweeps."""
    if op == "eigh":
        n = shape[0]
        return sweeps * sweep_flops(n)
    m, n = shape
    if op == "svd":
        return gram_flops(m, n) + sweeps * sweep_flops(n) + 2.0 * m * n * n
    if op == "pca":
        return standardize_flops(m, n) + gram_flops(m, n) + \
            sweeps * sweep_flops(n)
    raise ValueError(f"unknown op {op!r}")


def bound_s(flops: float, n_bytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the HBM bandwidth."""
    return max(flops / peak_flops, n_bytes / PEAK_BYTES)


def sweep_bound_s(n: int) -> float:
    """A grid sweep's bound, at the fp32 rate: the sweep's rotations are
    scalar fp32 work."""
    return bound_s(sweep_flops(n), sweep_bytes(n), PEAK_FP32)


def gram_bound_s(m: int, n: int) -> float:
    """The covariance kernel's bound at the TF32 tensor rate, the highest
    rate of any fp32-operand path, so that a 3xTF32 tile cannot read over
    its bound."""
    return bound_s(gram_flops(m, n), gram_bytes(m, n), PEAK_TF32)
