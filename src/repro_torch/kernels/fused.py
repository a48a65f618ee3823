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
    one (C, V) pair and writing the other each step, one grid barrier a
    step), and the grid's depth: two rounds a step where the pairs can
    cover every coordinate and every tile is resident at once.  The circle
    method moves each coordinate by at most one pair a round, so a block
    computes round r on its tile widened by one pair a side, keeps it in
    shared memory and stores round r + 1 alone: 391 barriers a sweep at
    n = 784, not 782, each value the same arithmetic on the same operands
    (a step of any other table runs one round a barrier, bitwise all the
    same; the kernel checks every step once a launch).  Bound of a sweep
    by operations, 9 n^2 (n - 1) flops (64 us at n = 784); the step's
    barrier and L2 round trips keep the grid kernel far from it.  On the
    H100 a sweep at n = 784 took 4.18-4.24 ms against 4.74-4.84 at one
    round a barrier (``scripts/kernel_ab.py jacobi``): a step of two
    rounds 10.7 us, its grid barrier 2.6, its stores' drain 2.0 and its
    loads, angles and staging 6.1, against 4.2, 4.1 and 4.0 for two
    rounds one barrier apart.  ``JACOBI_SWEEP.barriers`` reads the grid
    barriers the launches passed, as the kernel counts them.

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


class GridSweepInfo(KernelInfo):
    """The cooperative grid sweep's record, with ``barriers``: the grid
    barriers its launches passed, as the kernel counts them on the card
    (read back when asked: a device synchronization).  Launches under
    stream capture, and a CUDA graph's replays, are not counted."""

    @property
    def barriers(self) -> int:
        return sum(int(t.item()) for t in _BARRIERS.values())


# device index -> the int64 word the grid kernel adds its barriers to
_BARRIERS: dict = {}

JACOBI_SWEEP = GridSweepInfo("jacobi_sweep",
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
    depth: int = 1      # rounds a grid barrier (the grid kernel)


def sweep_smem_bytes(n: int, k: int) -> int:
    """Shared memory of the one-block-per-problem kernel: C and V with an
    odd row pitch (n | 1), and (c, s) and (p, q) of each pair (as
    ``smem_bytes`` in ``csrc/jacobi_sweep.cu``)."""
    return 4 * (2 * n * (n | 1) + 4 * k)


def sweep_plan(batch: int, n: int, k: int, smem_optin: int, sms: int,
               blocks_per_sm: int, staged_blocks_per_sm: int = 0
               ) -> SweepPlan:
    """Where a sweep over (batch, n, n) with k pairs a round runs: in
    shared memory, one block per problem, where C and V fit one block's
    opt-in shared memory (n <= 128 on the H100's 227 KiB); otherwise on
    the cooperative grid, one block per tile of every problem but never
    more than the blocks that can be resident at once (a grid barrier
    waits for every block).  A tile is 16 x 32 units, a unit being a pair
    or, where the k pairs cannot cover all n coordinates (the cyclic
    pivot), also each coordinate.

    The grid takes two rounds a barrier (depth 2) where the pairs can
    cover every coordinate (2k >= n, the circle method's rounds) and the
    ``staged_blocks_per_sm`` x ``sms`` blocks of that instance hold every
    tile at once (0 where its staging does not fit a block's shared
    memory), so that each block's two-round work is paid once a barrier;
    otherwise one round a barrier (``blocks_per_sm`` blocks an SM).  On
    the H100 at 32 x 256 x 256 (1024 tiles, two or three a block) two
    rounds a barrier took 3.95 ms a sweep against 3.14-3.20 at one
    (``scripts/kernel_ab.py jacobi``)."""
    if sweep_smem_bytes(n, k) <= smem_optin:
        return SweepPlan(JACOBI_SWEEP_SMEM, batch)
    resident = blocks_per_sm * sms
    if resident < 1:
        raise ValueError(f"jacobi_sweep_step: no block of the grid kernel "
                         f"fits an SM at n = {n}")
    units = k if 2 * k >= n else k + n
    rows, cols = SWEEP_TILE
    tiles = batch * (-(-units // rows)) * (-(-units // cols))
    if 2 * k >= n and tiles <= staged_blocks_per_sm * sms:
        return SweepPlan(JACOBI_SWEEP, tiles, 2)
    return SweepPlan(JACOBI_SWEEP, min(tiles, resident))


@functools.lru_cache(maxsize=None)
def _sweep_limits(index: int, n: int, k: int) -> Tuple[int, int, int, int]:
    """(opt-in shared memory a block, SMs, grid-kernel blocks an SM at one
    round a barrier, and at two) of CUDA device ``index`` at (n, k), from
    the CUDA runtime."""
    vals = [ctypes.c_int(0) for _ in range(4)]
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
    # the spare of the ping-pong, and at depth 2 the third buffer of a step
    # that runs one round a barrier; unused by the smem kernel and by a
    # single round
    spare = third = (Co, Vo)
    if grid and rounds > 1:
        work = torch.empty((4 if plan.depth > 1 and rounds > 2 else 2,
                            *C.shape), dtype=C.dtype, device=dev)
        spare = third = (work[0], work[1])
        if len(work) == 4:
            third = (work[2], work[3])
    # the grid barrier's word, and at depth 2 a flag a two-round step
    words = 1 + (rounds // 2 if plan.depth > 1 else 0)
    barrier = torch.zeros(words if grid else 0, dtype=torch.int32,
                          device=dev)
    issued = 0
    if grid and not torch.cuda.is_current_stream_capturing():
        if dev.index not in _BARRIERS:
            _BARRIERS[dev.index] = torch.zeros(1, dtype=torch.int64,
                                               device=dev)
        issued = _BARRIERS[dev.index].data_ptr()
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.repro_jacobi_sweep(
            C.data_ptr(), V.data_ptr(), pairs.data_ptr(), Co.data_ptr(),
            Vo.data_ptr(), spare[0].data_ptr(), spare[1].data_ptr(),
            third[0].data_ptr(), third[1].data_ptr(), barrier.data_ptr(),
            issued, batch, n, k, rounds, ANGLE_CODES[angle], int(not grid),
            plan.grid, plan.depth, stream(dev)), what)
    plan.kernel.launches += 1
    return Co, Vo
