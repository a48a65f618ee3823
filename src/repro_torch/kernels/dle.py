"""Wrapper of the DLE pivot-scan kernel (``csrc/dle.cu``).

``dle_scan`` replaces ``repro/kernels/dle.py::dle_scan`` (``pallas_call``
at :70): max |off-diagonal| of an (n, n) fp32 matrix and its flat index
p * n + q, with the TPU kernel's order of ties (tiles in row-major order,
the first maximum within a tile).  One launch writes each tile's best, a
one-block launch reduces them in tile order; the ragged edge is masked, so
nothing is padded.  Bound by bytes: C read once, 2.46 MB at n = 784
(0.73 us at 3.35 TB/s).

On a CPU tensor it returns the plain version (``kernels.ref.dle_scan``); on
a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import build
from . import ref as _ref
from .launch import KernelInfo, require, require_cuda, stream

DLE_SCAN = KernelInfo("dle_find_pivot", "src/repro_torch/csrc/dle.cu",
                      "src/repro/kernels/dle.py:70")


def dle_scan(c: torch.Tensor, tile: int = 128):
    """(max |off-diagonal| as a float32 0-d tensor, its flat index p * n + q
    as an int32 0-d tensor) of a square fp32 ``c``, scanned in ``tile`` x
    ``tile`` tiles."""
    if c.device.type == "cpu":
        return _ref.dle_scan(c, tile)
    what = "dle_scan"
    dev = require_cuda(what, c)
    require(c.ndim == 2 and c.shape[0] == c.shape[1], what,
            f"expected (n, n), got {tuple(c.shape)}")
    require(c.dtype == torch.float32, what, f"c must be float32, got "
            f"{c.dtype}")
    require(c.is_contiguous(), what, "c must be contiguous")
    n = c.shape[0]
    require(0 < n and n * n < 2 ** 31, what, f"n = {n} is out of range")
    require(0 < tile and tile * tile < 2 ** 31, what,
            f"tile = {tile} is out of range")
    grid_n = -(-n // tile)
    require(grid_n <= 65535, what, f"{grid_n} tiles a side exceed the grid")
    tile_val = torch.empty(grid_n * grid_n, dtype=torch.float32, device=dev)
    tile_idx = torch.empty(grid_n * grid_n, dtype=torch.int32, device=dev)
    val = torch.empty((), dtype=torch.float32, device=dev)
    idx = torch.empty((), dtype=torch.int32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        build.check(lib.repro_dle_scan(
            c.data_ptr(), tile_val.data_ptr(), tile_idx.data_ptr(),
            val.data_ptr(), idx.data_ptr(), n, tile, stream(dev)), what)
    DLE_SCAN.launches += 1
    return val, idx
