"""Wrapper of the MM-Engine kernel (``csrc/mm_engine.cu``).

``mm_engine`` replaces ``repro/kernels/mm_engine.py::mm_engine``
(``pallas_call`` at :68): a @ b with an fp32 accumulator, the output in a's
dtype.  The TPU kernel needs block multiples, so the reference pads; this
kernel masks the ragged edges and reads any strides, so nothing is padded
or copied (a transposed view goes in as it is).  Bound by bytes on the main
path: the projection (70000, 784) @ (784, 32) reads a once, 220 MB, about
68 us at 3.35 TB/s, against 52 us of fp32 CUDA-core work.  64 x 64 output
tiles with 4 x 4 register accumulators a thread; no tensor cores, so no
TF32 under the fp32 policy.

On a CPU tensor it returns the plain version (``kernels.ref.mm_engine``);
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import build
from . import ref as _ref
from .launch import KernelInfo, require, require_cuda, stream

MM_ENGINE = KernelInfo("mm_engine_matmul",
                       "src/repro_torch/csrc/mm_engine.cu",
                       "src/repro/kernels/mm_engine.py:68")

_TILE = 64  # output tile edge of csrc/mm_engine.cu


def _strides(t: torch.Tensor):
    """(batch, row, column) strides of a 2-D or 3-D operand; a 2-D operand
    has batch stride 0, which shares it across the batch."""
    if t.ndim == 2:
        return (0,) + tuple(t.stride())
    return tuple(t.stride())


def mm_engine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for a (m, k) or (B, m, k) and b (k, n) or (B, k, n), both
    float32 or both bfloat16; fp32 accumulation, a's dtype out."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return _ref.mm_engine(a, b)
    what = "mm_engine"
    dev = require_cuda(what, a, b)
    require(a.ndim in (2, 3) and b.ndim in (2, 3), what,
            f"operands must be 2-D or 3-D, got {tuple(a.shape)} and "
            f"{tuple(b.shape)}")
    require(a.dtype == b.dtype and a.dtype in (torch.float32, torch.bfloat16),
            what, f"operands must both be float32 or bfloat16, got {a.dtype} "
            f"and {b.dtype}")
    require(a.shape[-1] == b.shape[-2], what,
            f"inner dims differ: {tuple(a.shape)} @ {tuple(b.shape)}")
    batch = a.shape[0] if a.ndim == 3 else (b.shape[0] if b.ndim == 3 else 1)
    require(a.ndim == 2 or b.ndim == 2 or a.shape[0] == b.shape[0], what,
            f"batch dims differ: {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape[-2:]
    n = b.shape[-1]
    require(-(-m // _TILE) <= 65535 and batch <= 65535, what,
            f"shape {tuple(a.shape)} exceeds the launch grid")
    out = torch.empty((batch, m, n), dtype=a.dtype, device=dev)
    if out.numel() == 0:  # an empty grid is no launch
        return out if a.ndim == 3 or b.ndim == 3 else out[0]
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.repro_mm(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            int(a.dtype == torch.bfloat16), batch, m, n, k, *_strides(a),
            *_strides(b), stream(dev)), what)
    MM_ENGINE.launches += 1
    return out if a.ndim == 3 or b.ndim == 3 else out[0]
