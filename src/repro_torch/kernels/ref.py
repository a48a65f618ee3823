"""Plain PyTorch versions of the hot-path kernels (port of the reference
oracles in ``repro.kernels.ref``).

Each function is what the CUDA kernel computes, written with ordinary
tensor operations.  The kernel wrappers run these for tensors that lie on
the CPU, and ``chip_smoke.py`` holds each kernel against them on the card.
The three hot-path functions take one problem (2-D) or a batch with
leading dimensions.

Two functions stand where the reference has one oracle, because the TPU
kernel and the reference's oracle compute different things:

  ``dle_scan``   the Pallas kernel's tile-order scan (the reference's
                 oracle is the flat ``find_pivot``, which ranks ties and a
                 zero off-diagonal differently);
  ``cordic_rotation_params_q29``  the Pallas kernel's Q2.29 arithmetic
                 (seed round(2^29 / K), no fold before rotation mode);
                 ``cordic_rotation_params`` is the float oracle.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import cordic as _cordic

# rotation-mode seed of the standalone CORDIC kernel, round(2^29 / K); the
# core solver's seed round(f32(1/K) * 2^29) is 11 units larger
CORDIC_X0_KERNEL = int(round(float(_cordic._ONE) / _cordic._GAIN))
_NEG_INF = -1e30  # the mask value of the reference's attention


def mm_engine(a: torch.Tensor, b: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a @ b with a float32 accumulator (float64 for float64 operands);
    the output has a's dtype."""
    out_dtype = out_dtype or a.dtype
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    return torch.matmul(a.to(acc), b.to(acc)).to(out_dtype)


def covariance_gram(x: torch.Tensor, acc_dtype: torch.dtype = torch.float32,
                    out_dtype: Optional[torch.dtype] = None,
                    block_m: int = 0) -> torch.Tensor:
    """Gram matrix C = x^T x over the sample axis (-2) in ``acc_dtype``.
    Operands are widened to the accumulator first: a product of two bf16
    values is exact in float32, as it is in the kernel.

    ``block_m`` > 0 zero-pads the sample axis to a multiple of ``block_m``
    and sums the panels' Grams in order, as
    ``core.covariance.blocked_covariance`` does: the fp32 result is then
    bitwise the unfused Gram at the same ``block_m``.  0 is one product."""
    out_dtype = out_dtype or acc_dtype
    xa = x.to(acc_dtype)
    if block_m <= 0:
        return torch.matmul(xa.mT, xa).to(out_dtype)
    pad = (-x.shape[-2]) % block_m
    if pad:
        xa = torch.nn.functional.pad(xa, (0, 0, 0, pad))
    panels = xa.split(block_m, dim=-2)
    c = torch.matmul(panels[0].mT, panels[0])
    for xb in panels[1:]:
        c = c + torch.matmul(xb.mT, xb)
    return c.to(out_dtype)


def jacobi_sweep_step(C: torch.Tensor, V: torch.Tensor, pairs: torch.Tensor,
                      angle: str = "rutishauser"):
    """Pivot rounds, one after another: for each (k, 2) round of disjoint
    ``pairs`` ((k, 2) is one round, (R, k, 2) R of them), gather
    apq/app/aqq -> angle -> null-pivot guard -> rotate the rows, then the
    columns of C, and the columns of V.  ``pairs`` is shared across any
    batch dims."""
    from repro_torch.core.cordic import ANGLE_MODES
    from repro_torch.core.jacobi import (_apply_rotations_rowcol,
                                         _null_pivot_guard)
    pairs = pairs.to(device=C.device, dtype=torch.long)
    for round_pairs in (pairs[None] if pairs.ndim == 2 else pairs):
        p = round_pairs[:, 0]
        q = round_pairs[:, 1]
        apq = C[..., p, q]
        app = C[..., p, p]
        aqq = C[..., q, q]
        _, c, s = ANGLE_MODES[angle](apq, app, aqq)
        c, s = _null_pivot_guard(p, q, apq, c, s)
        C, V = _apply_rotations_rowcol(C, V, p, q, c.to(C.dtype),
                                       s.to(C.dtype))
    return C, V


def dle_scan(c: torch.Tensor, tile: int = 128):
    """(max |off-diagonal| as float32, flat index p * n + q) of an (n, n)
    matrix, as the Pallas DLE kernel finds them: the diagonal and the
    padding count as -1; the tiles of ``tile`` x ``tile`` are taken in
    row-major order and a later tile wins only with a strictly larger
    value; within a tile the first maximum in row-major order wins.  A
    tile holding a NaN in a valid entry has a NaN max, which is never
    larger, so the tile is skipped whole.  With no candidate (n = 1, or
    every tile NaN) it returns (-1, 0)."""
    n = c.shape[-1]
    if c.ndim != 2 or c.shape[0] != n:
        raise ValueError(f"dle_scan: expected (n, n), got {tuple(c.shape)}")
    pad = (-n) % tile
    mag = c.abs().to(torch.float32)
    ids = torch.arange(n + pad, device=c.device)
    invalid = ((ids[:, None] == ids[None, :]) | (ids[:, None] >= n)
               | (ids[None, :] >= n))
    mag = torch.nn.functional.pad(mag, (0, pad, 0, pad)).masked_fill(
        invalid, -1.0)
    g = (n + pad) // tile
    tiles = mag.reshape(g, tile, g, tile).permute(0, 2, 1, 3).reshape(
        g * g, tile * tile)
    tile_max, tile_arg = tiles.max(dim=1)   # first maximum in the tile
    tile_max = tile_max.masked_fill(tile_max.isnan(), -1.0)  # NaN tiles
    best = torch.argmax(tile_max)           # first tile with the maximum
    loc = tile_arg[best]
    p = (best // g) * tile + loc // tile
    q = (best % g) * tile + loc % tile
    found = tile_max[best] > -1.0
    val = torch.where(found, tile_max[best], torch.full_like(tile_max[best],
                                                             -1.0))
    idx = torch.where(found, p * n + q, torch.zeros_like(p))
    return val, idx.to(torch.int32)


def dle_pivot(c: torch.Tensor, tile: int = 128):
    """(p, q as int64, C[p, q], C[p, p], C[q, q]) at ``dle_scan``'s flat
    index: the pivot the DLE kernel gathers, (0, 0, C[0, 0], C[0, 0],
    C[0, 0]) with no candidate."""
    n = c.shape[-1]
    idx = dle_scan(c, tile)[1].long()
    p, q = idx // n, idx % n
    return p, q, c[p, q], c[p, p], c[q, q]


def cordic_rotation_params_q29(apq: torch.Tensor, app: torch.Tensor,
                               aqq: torch.Tensor):
    """(theta, cos, sin) of each pivot in the standalone CORDIC kernel's
    Q2.29 arithmetic: the core's vectoring mode for atan2(2 apq, app - aqq)
    (``core.cordic.cordic_atan2``, power-of-two scale from the exponent
    bits), theta = -angle / 2, then rotation mode from the seed
    round(2^29 / K) with no fold (|theta| <= pi / 2 converges)."""
    f32 = torch.float32
    theta = -0.5 * _cordic.cordic_atan2(2.0 * apq.to(f32),
                                        app.to(f32) - aqq.to(f32))
    zi = _cordic._to_fixed(theta)
    xi = torch.full_like(zi, CORDIC_X0_KERNEL)
    yi = torch.zeros_like(zi)
    for i in range(_cordic.CORDIC_ITERS):
        d = torch.where(zi >= 0, 1, -1).to(torch.int32)
        xi, yi, zi = (xi - d * (yi >> i), yi + d * (xi >> i),
                      zi - d * int(_cordic._ATAN_FIXED[i]))
    return theta, _cordic._from_fixed(xi), _cordic._from_fixed(yi)


def cordic_rotation_params(apq, app, aqq):
    """Float-exact rotation parameters (theta, cos, sin): the oracle the
    CORDIC kernel approximates."""
    f32 = torch.float32
    return _cordic.rotation_params(apq.to(f32), app.to(f32), aqq.to(f32))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Dense softmax attention in fp32 for q (BH, Sq, D), k/v (BH, Skv, D);
    query row i sits at position i + ``q_offset`` and, when causal, sees
    keys 0..i + q_offset (a masked score is -1e30).  Out in q's dtype."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    f32 = torch.float32
    s = torch.matmul(q.to(f32), k.to(f32).mT) * scale
    if causal:
        rows = torch.arange(q.shape[-2], device=q.device)[:, None] + q_offset
        cols = torch.arange(k.shape[-2], device=q.device)[None, :]
        s = s.masked_fill(rows < cols, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(f32)).to(q.dtype)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest, ties to even), back in fp32."""
    return t.to(torch.bfloat16).to(torch.float32)


def mamba_scan(u, delta, A, B, C, D_skip, return_state: bool = False,
               state_dtype: torch.dtype = torch.float32):
    """Selective scan, one step of t at a time with a (batch, D, N) state:
    x_t = exp(dt_t A) x_{t-1} + (dt_t u_t) B_t and
    y_t = x_t . C_t + D_skip u_t, for u, delta (batch, L, D), A (D, N),
    B, C (batch, L, N).  Out in u's dtype; with ``return_state``, (y,
    x_{L-1}), the state fp32.

    ``state_dtype``: float32, or bfloat16, the reference's
    ``ssm_dtype="bfloat16"`` scan: dt, A, B, C rounded to bf16 (r below),
    a_t = r(exp(r(dt_t A))), b_t = r(r(dt_t r(u_t)) B_t), the state
    x_t = r(r(a_t x_{t-1}) + b_t), each product and sum in fp32 and then
    rounded; y_t = x_t . C_t summed in fp32, plus D_skip u_t on the
    unrounded u.  The state returned holds bf16 values in fp32."""
    if state_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mamba_scan: state_dtype must be float32 or "
                         f"bfloat16, got {state_dtype}")
    f32 = torch.float32
    u32, dt32, B32, C32 = (t.to(f32) for t in (u, delta, B, C))
    A32 = A.to(f32)
    D32 = D_skip.to(f32)
    bf16 = state_dtype == torch.bfloat16
    if bf16:
        ub, dt32, A32, B32, C32 = (bf16_round(t) for t in
                                   (u32, dt32, A32, B32, C32))
    x = torch.zeros(u.shape[0], u.shape[2], A.shape[1], dtype=f32,
                    device=u.device)
    ys = []
    for t in range(u.shape[1]):
        u_t, dt_t = u32[:, t], dt32[:, t]
        if bf16:
            decay = bf16_round(torch.exp(bf16_round(dt_t[:, :, None]
                                                    * A32[None])))
            b_t = bf16_round(bf16_round(dt_t * ub[:, t])[:, :, None]
                             * B32[:, t, None, :])
            x = bf16_round(bf16_round(decay * x) + b_t)
        else:
            decay = torch.exp(dt_t[:, :, None] * A32[None])
            x = decay * x + (dt_t * u_t)[:, :, None] * B32[:, t, None, :]
        ys.append((x * C32[:, t, None, :]).sum(dim=2) + D32[None, :] * u_t)
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(u32)
    return (y.to(u.dtype), x) if return_state else y.to(u.dtype)
