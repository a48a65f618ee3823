"""Data Lookup Engine (DLE): max-|off-diagonal| pivot search (port of
``repro.core.dle``).

``find_pivot`` is the flat form the ``pivot="paper"`` solver uses; it works
on one (n, n) matrix or a batch (..., n, n).  ``find_pivot_tilewise``
reproduces the streaming tile-by-tile scan on one matrix.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Pivot(NamedTuple):
    p: torch.Tensor          # row index (int64, batch shape)
    q: torch.Tensor          # col index
    apq: torch.Tensor        # C[p, q]
    app: torch.Tensor        # C[p, p]
    aqq: torch.Tensor        # C[q, q]


def _pivot_at(C, p, q) -> Pivot:
    flat = C.flatten(-2)
    n = C.shape[-1]

    def at(i, j):
        return torch.take_along_dim(flat, (i * n + j)[..., None], -1)[..., 0]

    return Pivot(p, q, at(p, q), at(p, p), at(q, q))


def find_pivot(C) -> Pivot:
    """Global max |off-diagonal| element of a symmetric matrix (the first
    one in row-major order on ties, as ``jnp.argmax``)."""
    n = C.shape[-1]
    eye = torch.eye(n, dtype=C.dtype, device=C.device)
    offdiag = torch.abs(C) * (1.0 - eye)
    idx = torch.argmax(offdiag.flatten(-2), dim=-1)
    return _pivot_at(C, idx // n, idx % n)


def find_pivot_tilewise(C, tile: int) -> Pivot:
    """Streaming-scan semantics on one (n, n) matrix: per-tile max with
    tile-aware diagonal masking, then a reduce over the tile stream."""
    n = C.shape[0]
    pad = (-n) % tile
    Cp = torch.nn.functional.pad(C, (0, pad, 0, pad)) if pad else C
    g = Cp.shape[0] // tile
    tiles = Cp.reshape(g, tile, g, tile).permute(0, 2, 1, 3)
    ii = torch.arange(tile, device=C.device)
    gg = torch.arange(g, device=C.device)
    local_eye = ii[:, None] == ii[None, :]
    block_diag = gg[:, None] == gg[None, :]
    mask = block_diag[:, :, None, None] & local_eye[None, None, :, :]
    zero = torch.zeros((), dtype=C.dtype, device=C.device)
    mag = torch.where(mask, zero, torch.abs(tiles))
    row_ids = (gg * tile)[:, None, None, None] + ii[None, None, :, None]
    col_ids = (gg * tile)[None, :, None, None] + ii[None, None, None, :]
    mag = torch.where((row_ids < n) & (col_ids < n), mag, zero)
    tile_max = mag.amax(dim=(2, 3))
    tile_arg = mag.reshape(g, g, tile * tile).argmax(dim=2)
    best_tile = torch.argmax(tile_max.reshape(-1))
    bi = best_tile // g
    bj = best_tile % g
    loc = tile_arg[bi, bj]
    p = bi * tile + loc // tile
    q = bj * tile + loc % tile
    return _pivot_at(Cp, p, q)
