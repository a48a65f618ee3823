"""Wrapper of the MM-Engine kernel (``csrc/mm_engine.cu``).

``mm_engine`` replaces ``repro/kernels/mm_engine.py::mm_engine``
(``pallas_call`` at :68): a @ b with an fp32 accumulator, the output in a's
dtype.  The TPU kernel needs block multiples, so the reference pads; this
kernel masks the ragged edges, so nothing is padded or copied (a
transposed view, a column slice or a strided subsample goes in as it is).
``choose_kernel`` picks the tile and each operand's layout from the
operands' strides before the launch, and nothing falls back after one.

``mm_engine_matmul`` (``csrc/mm_engine.cu``) takes every layout on the
tensor cores, fed by a cp.async ring.  Each operand is copied along one of
its last two dims: the one of unit stride, in 16-, 8- or 4-byte copies (as
the base, the leading stride and the batch stride allow), or, where
neither has unit stride, the one of the smaller stride, one element a copy
(``Layout.step`` apart; 0 for an expanded operand).  fp32 operands as three
tf32 products (hi*hi + hi*lo + lo*hi, fp32-grade sums), bf16 as one.  A
narrow 64 x 32 tile for n <= 32 (the projection (70000, 784) @ (784, 32),
bound by the bytes of a: 220 MB, 68 us at 3.35 TB/s), a 128 x 128 tile
otherwise.

On a CPU tensor it returns the plain version (``kernels.ref.mm_engine``);
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import build
from . import ref as _ref
from .launch import KernelInfo, copy_bytes, require, require_cuda, stream

_TPU = "src/repro/kernels/mm_engine.py:68"
MM_ENGINE = KernelInfo("mm_engine_matmul",
                       "src/repro_torch/csrc/mm_engine.cu", _TPU)
MM_KERNELS = (MM_ENGINE,)

NARROW_N = 32        # n up to this takes the 64 x 32 tile of mm_engine.cu


@dataclasses.dataclass(frozen=True)
class Layout:
    """How ``csrc/mm_engine.cu`` reads one operand: ``contiguous`` names
    the dim its copies run along ("k" along the inner dim, "mn" along the
    outer one), ``step`` that dim's stride (1 unless no dim has unit
    stride), ``ld`` the other dim's stride, ``batch_stride`` the batch's
    (0 shares the operand), ``copy_bytes`` the width of one copy."""
    contiguous: str
    ld: int
    batch_stride: int
    copy_bytes: int
    step: int = 1


@dataclasses.dataclass(frozen=True)
class Route:
    kernel: KernelInfo
    narrow: bool
    a: Layout
    b: Layout


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, row, column) strides of a 2-D or 3-D operand; a 2-D operand,
    or a batch of one, has batch stride 0."""
    if t.ndim == 2 or t.shape[0] == 1:
        return (0,) + tuple(t.stride()[-2:])
    return tuple(t.stride())


def _layout(t: torch.Tensor, inner: int) -> Layout:
    """The layout of operand ``t`` whose dim ``inner`` (-1 for a, whose
    last dim is k; -2 for b, whose k is the row dim) is k.  Copies run
    along a dim of unit stride where there is one (a dim of size 1 has any
    stride, so it counts), else along the dim of the smaller stride, one
    element a copy."""
    sb, rs, cs = _strides(t)
    rows, cols = t.shape[-2:]
    dims = ((-1, cs, rs, rows, cols), (-2, rs, cs, cols, rows))
    for dim, stride, other, other_size, size in dims:
        if stride == 1 or size == 1:
            ld = other if other_size > 1 else 0
            return Layout("k" if dim == inner else "mn", ld, sb,
                          copy_bytes(t, ld, sb))
    dim, stride, other, other_size, _ = min(dims, key=lambda x: x[1])
    return Layout("k" if dim == inner else "mn",
                  other if other_size > 1 else 0, sb, t.element_size(),
                  stride)


def choose_kernel(a: torch.Tensor, b: torch.Tensor) -> Route:
    """The tile (narrow for n <= 32) and each operand's layout for a @ b,
    from the operands' strides, alignment and n."""
    return Route(MM_ENGINE, b.shape[-1] <= NARROW_N, _layout(a, -1),
                 _layout(b, -2))


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
    require(max(m, k) < 2 ** 31 and -(-n // NARROW_N) <= 65535
            and batch <= 65535, what,
            f"shape {tuple(a.shape)} @ {tuple(b.shape)} exceeds the launch "
            f"grid")
    out = torch.empty((batch, m, n), dtype=a.dtype, device=dev)
    if out.numel() == 0:  # an empty grid is no launch
        return out if a.ndim == 3 or b.ndim == 3 else out[0]
    route = choose_kernel(a, b)
    la, lb, es = route.a, route.b, a.element_size()
    lib = build.library()
    with torch.cuda.device(dev):
        status = lib.repro_mm(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            int(a.dtype == torch.bfloat16), int(route.narrow), batch, m, n,
            k, la.batch_stride, la.ld, la.step, int(la.contiguous == "mn"),
            la.copy_bytes // es, lb.batch_stride, lb.ld, lb.step,
            int(lb.contiguous == "mn"), lb.copy_bytes // es, stream(dev))
        build.check(status, f"{what} ({route.kernel.name})")
    route.kernel.launches += 1
    return out if a.ndim == 3 or b.ndim == 3 else out[0]
