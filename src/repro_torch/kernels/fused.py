"""Wrappers of the fused hot-path kernels: the one-call Gram matrix and the
one-call Jacobi pivot round (``csrc/covariance.cu``, ``csrc/jacobi_sweep.cu``).

``fused_covariance``
    replaces ``repro/kernels/fused.py::fused_covariance`` (``pallas_call``
    at :102).  (B, m, n) -> (B, n, n) fp32 over fp32 or bf16 operands, on
    the tensor cores through the tile core shared with the MM-Engine
    (``csrc/gemm_tile.cuh``): fp32 operands as three tf32 products (hi*hi
    + hi*lo + lo*hi, fp32-grade sums), bf16 as one.  Bound by operations:
    m * n * (n + 1) flops for the upper triangle, 0.64 ms at 70000 x 784
    against 67 TFLOP/s fp32 (0.26 ms of 3xTF32 work at 495 TFLOP/s).  Each
    block computes one 128 x 128 upper-triangle tile and mirrors it; the m
    axis is split across blocks into fp32 partial Grams, summed in a fixed
    order, so that the 28 tiles at n = 784 fill 132 SMs.

``jacobi_sweep_step``
    replaces ``repro/kernels/fused.py::jacobi_sweep_step`` (``pallas_call``
    at :162).  One pivot round over (B, n, n) C and V sharing one (k, 2)
    ``pairs``: a small launch computes the angle and the null-pivot guard
    once per (b, pair), then an out-of-place launch writes every C''[r, c]
    from the 2 x 2 block of the old C at (pair(r), pair(c)) and every
    V''[r, c] from V's two columns of pair(c).  Bound by bytes: C and V read
    and written once, 16 n^2 bytes (3 us at n = 784); the host's launch per
    round dominates that, which one launch per sweep would remove.

On a CPU tensor each wrapper returns its plain version (``kernels.ref``); on
a CUDA tensor it launches its kernel or raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import build
from . import ref as _ref
from .launch import KernelInfo, copy_bytes, require, require_cuda, stream

COVARIANCE = KernelInfo("covariance", "src/repro_torch/csrc/covariance.cu",
                        "src/repro/kernels/fused.py:102")
JACOBI_SWEEP = KernelInfo("jacobi_sweep",
                          "src/repro_torch/csrc/jacobi_sweep.cu",
                          "src/repro/kernels/fused.py:162")

ANGLE_CODES = {"rutishauser": 0, "atan2": 1, "cordic": 2}
COV_TILE = 128          # output tile edge of csrc/covariance.cu
COV_BLOCKS_PER_SM = 2   # blocks of it an SM holds (shared memory)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cov_splits(m: int, n: int, batch: int, block_m: int, sms: int) -> int:
    """How many slices of the m axis the Gram kernel runs in parallel: as
    many as fit the card in one wave of ``COV_BLOCKS_PER_SM`` blocks an
    SM, each slice at least one ``block_m`` panel.  More slices do the
    same work in more waves and add an n x n partial each; on the H100 at
    70000 x 784, two waves took 1% (fp32) and 7% (bf16) longer and four
    waves 2% and 17% (``scripts/kernel_ab.py gemm``)."""
    tiles = -(-n // COV_TILE)
    blocks = batch * tiles * (tiles + 1) // 2
    want = COV_BLOCKS_PER_SM * sms // blocks
    return max(1, min(want, -(-m // block_m), 65535))


def cov_slices(m: int, n: int, batch: int, block_m: int,
               sms: int) -> Tuple[int, int]:
    """(slices, rows a slice) of the m axis: ``cov_splits`` slices of whole
    ``block_m`` panels, the last one ragged, none empty."""
    block_m = max(block_m, 1)
    splits = cov_splits(m, n, batch, block_m, sms)
    rows = -(-m // splits)
    per = -(-rows // block_m) * block_m
    return (-(-m // per) if m else 1), per


def fused_covariance(x: torch.Tensor, *, block_m: int = 1024) -> torch.Tensor:
    """C = x^T x over the sample axis for x (m, n) or (B, m, n) of fp32 or
    bf16; fp32 out.  ``block_m`` is the granule of the m-axis split."""
    if x.device.type == "cpu":
        return _ref.covariance_gram(x)
    what = "fused_covariance"
    dev = require_cuda(what, x)
    require(x.ndim in (2, 3), what, f"expected (m, n) or (B, m, n), got "
            f"{tuple(x.shape)}")
    require(x.dtype in (torch.float32, torch.bfloat16), what,
            f"operands must be float32 or bfloat16, got {x.dtype}")
    require(x.is_contiguous(), what, "x must be contiguous")
    xb = x if x.ndim == 3 else x[None]
    batch, m, n = xb.shape
    require(0 < batch <= 65535 and n > 0, what,
            f"cannot launch over shape {tuple(x.shape)}")
    splits, per = cov_slices(m, n, batch, block_m, _sm_count(dev.index))
    out = torch.empty((batch, n, n), dtype=torch.float32, device=dev)
    partial = out if splits == 1 else torch.empty(
        (splits, batch, n, n), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        s = stream(dev)
        build.check(lib.repro_cov_gram(
            xb.data_ptr(), int(x.dtype == torch.bfloat16), partial.data_ptr(),
            batch, m, n, splits, per,
            copy_bytes(xb, n, m * n) // xb.element_size(), s), what)
        if splits > 1:
            build.check(lib.repro_cov_reduce(
                partial.data_ptr(), out.data_ptr(), batch * n * n, splits, s),
                what)
    COVARIANCE.launches += 1
    return out if x.ndim == 3 else out[0]


def jacobi_sweep_step(C: torch.Tensor, V: torch.Tensor, pairs: torch.Tensor,
                      *, angle: str = "rutishauser",
                      out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One pivot round over C, V (n, n) or (B, n, n) fp32 with the (k, 2)
    int32 ``pairs`` shared across the batch; returns (C'', V'').

    The kernel works out of place: ``out`` may name the two tensors to write
    (they must not be C or V); otherwise they are allocated.  The plain
    version on a CPU tensor ignores ``out``."""
    if C.device.type == "cpu":
        return _ref.jacobi_sweep_step(C, V, pairs, angle=angle)
    what = "jacobi_sweep_step"
    dev = require_cuda(what, C, V, pairs)
    require(angle in ANGLE_CODES, what, f"unknown angle mode {angle!r}")
    require(C.ndim in (2, 3) and C.shape[-1] == C.shape[-2], what,
            f"C must be (n, n) or (B, n, n), got {tuple(C.shape)}")
    require(V.shape == C.shape, what, "V must have C's shape")
    require(C.dtype == torch.float32 and V.dtype == torch.float32, what,
            "C and V must be float32")
    require(pairs.dtype == torch.int32 and pairs.ndim == 2
            and pairs.shape[1] == 2, what, "pairs must be (k, 2) int32")
    require(C.is_contiguous() and V.is_contiguous()
            and pairs.is_contiguous(), what, "C, V and pairs must be "
            "contiguous")
    n = C.shape[-1]
    batch = C.shape[0] if C.ndim == 3 else 1
    k = pairs.shape[0]
    if out is None:
        Co, Vo = torch.empty_like(C), torch.empty_like(V)
    else:
        Co, Vo = out
        require(Co.shape == C.shape and Vo.shape == C.shape
                and Co.dtype == torch.float32 and Vo.dtype == torch.float32
                and Co.is_contiguous() and Vo.is_contiguous()
                and Co.device == dev and Vo.device == dev, what,
                "out must be two contiguous float32 tensors shaped like C")
        ptrs = {C.data_ptr(), V.data_ptr()}
        require(Co.data_ptr() not in ptrs and Vo.data_ptr() not in ptrs
                and Co.data_ptr() != Vo.data_ptr(), what,
                "out must not alias C or V")
    cs = torch.empty((batch, k, 2), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.repro_jacobi_sweep(
            C.data_ptr(), V.data_ptr(), pairs.data_ptr(), cs.data_ptr(),
            Co.data_ptr(), Vo.data_ptr(), batch, n, k, ANGLE_CODES[angle],
            stream(dev)), what)
    JACOBI_SWEEP.launches += 1
    return Co, Vo
