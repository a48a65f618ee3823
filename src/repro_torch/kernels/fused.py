"""Wrappers of the fused hot-path kernels: the one-call Gram matrix and the
one-call Jacobi sweep (``csrc/covariance.cu``, ``csrc/jacobi_sweep.cu``).

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
    at :162).  R pivot rounds over (B, n, n) C and V sharing one (R, k, 2)
    ``pairs`` (a whole sweep) in one launch, with C and V held on chip
    between rounds.  ``sweep_plan`` picks one of two kernels before the
    launch: ``jacobi_sweep_smem`` (one block per problem, C and V in
    shared memory, where they fit: n <= 128 on the H100) or
    ``jacobi_sweep`` (a persistent cooperative grid, C and V in L2, each
    thread owning the 2 x 2 blocks of C and V at (pair i, pair j), reading
    one (C, V) pair and writing the other each round, one grid barrier a
    round).  Bound of a sweep by operations, 9 n^2 (n - 1) flops (64 us at
    n = 784); each round's barrier and L2 round trips keep the grid kernel
    far from it.

On a CPU tensor each wrapper returns its plain version (``kernels.ref``); on
a CUDA tensor it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import build
from . import ref as _ref
from .launch import KernelInfo, copy_bytes, require, require_cuda, stream

COVARIANCE = KernelInfo("covariance", "src/repro_torch/csrc/covariance.cu",
                        "src/repro/kernels/fused.py:102")
JACOBI_SWEEP = KernelInfo("jacobi_sweep",
                          "src/repro_torch/csrc/jacobi_sweep.cu",
                          "src/repro/kernels/fused.py:162")
JACOBI_SWEEP_SMEM = KernelInfo("jacobi_sweep_smem",
                               "src/repro_torch/csrc/jacobi_sweep.cu",
                               "src/repro/kernels/fused.py:162")

ANGLE_CODES = {"rutishauser": 0, "atan2": 1, "cordic": 2}
COV_TILE = 128          # output tile edge of csrc/covariance.cu
COV_BLOCKS_PER_SM = 2   # blocks of it an SM holds (shared memory)
SWEEP_TILE = (16, 32)   # (pair rows, pair columns) of a grid-kernel tile


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
        return _ref.covariance_gram(x, block_m=block_m)
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


class SweepPlan(NamedTuple):
    kernel: KernelInfo  # JACOBI_SWEEP_SMEM or JACOBI_SWEEP
    grid: int           # blocks: one per problem, or the persistent grid


def sweep_smem_bytes(n: int, k: int) -> int:
    """Shared memory of the one-block-per-problem kernel: C and V with an
    odd row pitch (n | 1), and (c, s) and (p, q) of each pair (as
    ``smem_bytes`` in ``csrc/jacobi_sweep.cu``)."""
    return 4 * (2 * n * (n | 1) + 4 * k)


def sweep_plan(batch: int, n: int, k: int, smem_optin: int, sms: int,
               blocks_per_sm: int) -> SweepPlan:
    """Where a sweep over (batch, n, n) with k pairs a round runs: in
    shared memory, one block per problem, where C and V fit one block's
    opt-in shared memory (n <= 128 on the H100's 227 KiB); otherwise on
    the cooperative grid, one block per tile of every problem but never
    more than the ``blocks_per_sm`` x ``sms`` blocks that can be resident
    at once (a grid barrier waits for every block).  A tile is 16 x 32
    units, a unit being a pair or, where the k pairs cannot cover all n
    coordinates (the cyclic pivot), also each coordinate."""
    if sweep_smem_bytes(n, k) <= smem_optin:
        return SweepPlan(JACOBI_SWEEP_SMEM, batch)
    resident = blocks_per_sm * sms
    if resident < 1:
        raise ValueError(f"jacobi_sweep_step: no block of the grid kernel "
                         f"fits an SM at n = {n}")
    units = k if 2 * k >= n else k + n
    rows, cols = SWEEP_TILE
    tiles = batch * (-(-units // rows)) * (-(-units // cols))
    return SweepPlan(JACOBI_SWEEP, min(tiles, resident))


@functools.lru_cache(maxsize=None)
def _sweep_limits(index: int, n: int, k: int) -> Tuple[int, int, int]:
    """(opt-in shared memory a block, SMs, grid-kernel blocks an SM) of
    CUDA device ``index`` at (n, k), from the CUDA runtime."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(index):
        build.check(build.library().repro_jacobi_sweep_limits(
            n, k, *(ctypes.byref(v) for v in vals)), "jacobi_sweep_step")
    return tuple(v.value for v in vals)


def jacobi_sweep_step(C: torch.Tensor, V: torch.Tensor, pairs: torch.Tensor,
                      *, angle: str = "rutishauser",
                      out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Pivot rounds over C, V (n, n) or (B, n, n) fp32 with int32 ``pairs``
    shared across the batch: (k, 2) for one round, (R, k, 2) for R rounds
    applied in order; returns (C'', V'') after the last round.

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
    require(pairs.dtype == torch.int32 and pairs.ndim in (2, 3)
            and pairs.shape[-1] == 2 and pairs.numel() > 0, what,
            "pairs must be (k, 2) or (R, k, 2) int32, k and R > 0")
    require(C.is_contiguous() and V.is_contiguous()
            and pairs.is_contiguous(), what, "C, V and pairs must be "
            "contiguous")
    n = C.shape[-1]
    batch = C.shape[0] if C.ndim == 3 else 1
    rounds, k = (1, pairs.shape[0]) if pairs.ndim == 2 else pairs.shape[:2]
    require(0 < batch and n > 0, what, f"cannot launch over shape "
            f"{tuple(C.shape)}")
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
    plan = sweep_plan(batch, n, k, *_sweep_limits(dev.index, n, k))
    grid = plan.kernel is JACOBI_SWEEP
    spare = (Co, Vo)  # unused by the smem kernel and by a single round
    if grid and rounds > 1:
        spare = (torch.empty_like(C), torch.empty_like(V))
    barrier = torch.zeros(1 if grid else 0, dtype=torch.int32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.repro_jacobi_sweep(
            C.data_ptr(), V.data_ptr(), pairs.data_ptr(), Co.data_ptr(),
            Vo.data_ptr(), spare[0].data_ptr(), spare[1].data_ptr(),
            barrier.data_ptr(), batch, n, k, rounds, ANGLE_CODES[angle],
            int(not grid), plan.grid, stream(dev)), what)
    plan.kernel.launches += 1
    return Co, Vo
