"""Wrapper of the DLE pivot-scan kernel (``csrc/dle.cu``).

``dle_scan`` replaces ``repro/kernels/dle.py::dle_scan`` (``pallas_call``
at :70): max |off-diagonal| of an (n, n) fp32 matrix and its flat index
p * n + q, with the TPU kernel's order of ties (tiles in row-major order,
the first maximum within a tile) and its NaN rule (a tile holding a NaN in
a valid entry is skipped whole).  ``dle_pivot`` returns the pivot the
Jacobi step needs, (p, q, C[p, q], C[p, p], C[q, q]), from the same launch:
one launch a call, its grid filling the card, its last block gathering the
pivot into one 40-byte output.  Bound by bytes: C read once, 2.46 MB at
n = 784 (0.73 us at 3.35 TB/s).

The kernel reduces through per-tile slots and a ticket in scratch that it
leaves zeroed; the wrapper keeps that scratch for each (device, stream),
allocated (zeroed) on a stream's first call or when the tile grid grows.
Calls queued on one stream run in order, so they share it.

On a CPU tensor it returns the plain version (``kernels.ref``); on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import build
from . import ref as _ref
from .launch import KernelInfo, call_on, raw_stream, require, require_cuda

DLE_SCAN = KernelInfo("dle_find_pivot", "src/repro_torch/csrc/dle.cu",
                      "src/repro/kernels/dle.py:70")

# csrc/dle.cu's block: ROWS rows x COLS columns inside one tile
ROWS, COLS = 16, 128
_LIMIT = 46341  # n and tile below it keep n^2 and tile^2 under 2^31
# (device index, stream handle) -> int64 scratch: [ticket, one slot a tile]
_SCRATCH: dict = {}


def launch_grid(n: int, tile: int):
    """The kernel's grid (x: column chunks, y: row strips) for an (n, n)
    matrix in ``tile`` x ``tile`` tiles; each block lies in one tile."""
    g = -(-n // tile)
    edge = n - (g - 1) * tile
    return ((g - 1) * -(-tile // COLS) + -(-edge // COLS),
            (g - 1) * -(-tile // ROWS) + -(-edge // ROWS))


def _scratch(dev: int, stream: int, n: int, tile: int) -> torch.Tensor:
    tiles = (-(-n // tile)) ** 2
    buf = _SCRATCH.get((dev, stream))
    if buf is None or buf.numel() <= tiles:
        buf = torch.zeros(1 + tiles, dtype=torch.int64,
                          device=torch.device("cuda", dev))
        _SCRATCH[(dev, stream)] = buf
    return buf


def _refuse(c: torch.Tensor, tile: int) -> None:
    """Raise with the first check that ``c`` and ``tile`` fail."""
    what = "dle_scan"
    require_cuda(what, c)
    require(c.ndim == 2 and c.shape[0] == c.shape[1], what,
            f"expected (n, n), got {tuple(c.shape)}")
    require(c.dtype == torch.float32, what, f"c must be float32, got "
            f"{c.dtype}")
    require(c.is_contiguous(), what, "c must be contiguous")
    require(0 < c.shape[0] < _LIMIT, what, f"n = {c.shape[0]} is out of "
            f"range")
    require(0 < tile < _LIMIT, what, f"tile = {tile} is out of range")


def _launch(c: torch.Tensor, tile: int) -> torch.Tensor:
    """One launch; returns the (5,) int64 output: p, q, then float32
    C[p, q], C[p, p], C[q, q], the value, then the int32 flat index."""
    n = c.shape[-1]
    if not (c.is_cuda and c.dim() == 2 and c.shape[0] == n
            and c.dtype == torch.float32 and c.is_contiguous()
            and 0 < n < _LIMIT and 0 < tile < _LIMIT):
        _refuse(c, tile)
    dev = c.get_device()
    stream = raw_stream(dev)
    scratch = _scratch(dev, stream, n, tile)
    out = torch.empty(5, dtype=torch.int64, device=c.device)
    ptr = c.data_ptr()
    vec = 4 if n % 4 == 0 and tile % 4 == 0 and ptr % 16 == 0 else 1
    status = call_on(dev, build.library().repro_dle_pivot, ptr,
                     out.data_ptr(), scratch.data_ptr(), n, tile, vec,
                     stream)
    if status:
        del _SCRATCH[(dev, stream)]  # a failed launch may leave it dirty
        build.check(status, "dle_scan")
    DLE_SCAN.launches += 1
    return out


def dle_pivot(c: torch.Tensor, tile: int = 128):
    """(p, q as int64, C[p, q], C[p, p], C[q, q]) as 0-d tensors: the pivot
    at ``dle_scan``'s index of a square fp32 ``c`` (at index 0 when there
    is no candidate)."""
    if c.device.type == "cpu":
        return _ref.dle_pivot(c, tile)
    out = _launch(c, tile)
    f = out.view(torch.float32)
    return out[0], out[1], f[4], f[5], f[6]


def dle_scan(c: torch.Tensor, tile: int = 128):
    """(max |off-diagonal| as a float32 0-d tensor, its flat index p * n + q
    as an int32 0-d tensor) of a square fp32 ``c``, scanned in ``tile`` x
    ``tile`` tiles; (-1, 0) with no candidate."""
    if c.device.type == "cpu":
        return _ref.dle_scan(c, tile)
    out = _launch(c, tile)
    return out.view(torch.float32)[7], out.view(torch.int32)[8]
