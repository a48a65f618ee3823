"""Mamba-1 selective-SSM block, the mixer of falcon-mamba's and jamba's
mamba layers (port of ``repro.models.mamba``).

Prefill (``apply_mamba``) runs the causal depthwise conv, the SSM
parameters and then ONE ``kernels.ops.mamba_scan(..., return_state=True)``
call a layer, where the reference runs its chunked associative scan
(``_chunked_scan``): on the card that is the ``mamba_scan`` kernel, on the
CPU its plain version.  Both compute the same recurrence in the state
dtype ``ssm_dtype`` gives, so ``mamba_chunk`` (the reference's chunk
length) changes no result here; the two sum in other orders, within that
dtype's rounding.  Where
gradients flow, the op's backward (``kernels.grad``) recomputes the
states in chunks of ``mamba_chunk``.  Decode
(``decode_mamba``) is the reference's plain one-step recurrence in
PyTorch: the reference calls no kernel there either.

Dtypes follow the reference's default ``ssm_dtype="float32"``: the
projections and the conv run in the model's dtype, ``x_proj``'s output is
cast to fp32, ``dt`` is ``softplus(dt_r @ dt_w + dt_b)`` in fp32, the scan
takes u = the conv output, dt, B and C in fp32, and the gate ``silu(z)``
is applied in fp32 before the cast back.  ``ssm_dtype="bfloat16"`` keeps
the scan's state in bf16 as the reference does: the op's bf16-state
scan (``state_dtype=torch.bfloat16``: dt, A, B, C and the state rounded
where the reference's bf16 scan rounds, y summed in fp32, D u on the
unrounded u; on the card the kernel's bf16-state instance).  The cache
keeps that final state in fp32 (bf16 values), which decode, the
reference's fp32 recurrence either way, takes as the reference's
promotes its bf16 one.  Any other ``ssm_dtype`` raises a ``KeyError``,
as the reference does.
``ssm_impl="kernel_proxy"`` is the reference's dry-run stand-in for the
scan kernel's memory traffic, not a numerics path: prefill reads each
scan input once and writes y once (y = u dt (B . C) + D u), calls no
kernel, and leaves a zero final state; decode is the plain recurrence
either way.

On a mesh (``rules``; ``REPLICATED`` by default) the layer is
tensor-parallel over ``d_inner`` with the reference's roles: ``in_proj``
("fsdp", "tp") column-parallel, stored as this rank's channels of its x
half and of its z half together (``CHUNKS``: the dim is two pieces, each
split); the conv, ``dt_w``, ``dt_b``, ``A_log`` and ``D`` on this rank's
channels; ``x_proj`` ("tp", None) row-parallel, its partial output
all-reduced before ``dt``/B/C; ``out_proj`` ("tp", "fsdp") row-parallel,
its partial output all-reduced.  The scan kernel runs on this rank's
channels and the decode state's ``d_inner`` is sharded (("batch", "tp",
None)).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..kernels import ops
from ..parallel import collectives as C
from ..parallel.sharding import REPLICATED
from .config import ModelConfig
from .layers import _normal, _param


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, d_conv - 1, d_inner), the last raw inputs
    state: torch.Tensor  # (B, d_inner, N) fp32 (bf16 values after a bf16
                         # prefill)


class Mamba(nn.Module):
    """``in_proj`` (d, 2 di), ``conv_w`` (K, di), ``conv_b`` (di,),
    ``x_proj`` (di, R + 2N), ``dt_w`` (R, di) in the model's dtype;
    ``dt_b`` (di,), ``A_log`` (di, N), ``D`` (di,) in fp32; ``out_proj``
    (di, d)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        cfg.ssm_torch_dtype()  # an unknown ssm_dtype raises
        dt = cfg.torch_dtype()
        d, di, N, R, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.dt_rank, cfg.d_conv)

        def empty(shape, dtype=dt):
            return _param(torch.empty(shape, dtype=dtype, device=device))

        self.in_proj = empty((d, 2 * di))
        self.conv_w = empty((K, di))
        self.conv_b = empty((di,))
        self.x_proj = empty((di, R + 2 * N))
        self.dt_w = empty((R, di))
        self.dt_b = empty((di,), torch.float32)
        self.A_log = empty((di, N), torch.float32)
        self.D = empty((di,), torch.float32)
        self.out_proj = empty((di, d))

    # in_proj's dim 1 is two pieces (x, z), each split over "model"
    CHUNKS = {"in_proj": {1: 2}}

    def roles(self) -> dict:
        return {"in_proj": ("fsdp", "tp"), "conv_w": (None, "tp"),
                "conv_b": ("tp",), "x_proj": ("tp", None),
                "dt_w": (None, "tp"), "dt_b": ("tp",), "A_log": ("tp", None),
                "D": ("tp",), "out_proj": ("tp", "fsdp")}

    def reset_parameters(self, gen: Optional[torch.Generator]) -> None:
        """The reference's ``init_mamba``: normal projections scaled by
        1/sqrt(fan-in), conv bias 0, dt bias softplus^-1(0.01), S4D-real
        A = -(1..N) a channel, D = 1."""
        dev = self.in_proj.device
        for w in (self.in_proj, self.conv_w, self.x_proj, self.dt_w,
                  self.out_proj):
            _normal(gen, w, 1.0 / math.sqrt(w.shape[0]))
        self.conv_b.zero_()
        self.dt_b.copy_(torch.log(torch.expm1(torch.full_like(self.dt_b,
                                                          0.01))))
        n = self.A_log.shape[1]
        self.A_log.copy_(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=dev)).expand_as(self.A_log))
        self.D.fill_(1.0)


def _ssm_params(p: Mamba, xc: torch.Tensor, cfg: ModelConfig,
                rules=REPLICATED):
    """xc (..., di), the conv output -> (dt, B, C) in fp32.  On a mesh
    ``x_proj``'s partial sums over this rank's channels are summed in
    fp32, and the result enters the channel-parallel region again."""
    R, N = cfg.dt_rank, cfg.ssm_state
    if rules.size("tp") == 1:
        proj = (xc @ p.x_proj).float()
    else:
        proj = C.copy_to(C.reduce_from(xc.float() @ p.x_proj.float(),
                                       rules), rules)
    dt_r, B_ssm, C_ssm = torch.split(proj, [R, N, N], dim=-1)
    dt = F.softplus(dt_r @ p.dt_w.float() + p.dt_b)
    return dt, B_ssm, C_ssm


def apply_mamba(p: Mamba, x: torch.Tensor, cfg: ModelConfig, *,
                chunk: Optional[int] = None, return_cache: bool = False,
                rules=REPLICATED):
    """Train/prefill path.  x (B, S, d) -> (y, cache or None).  ``chunk``
    (default ``cfg.mamba_chunk``) is the backward's recompute chunk; the
    forward runs each channel over all of S.  The cache's conv part is the
    last d_conv - 1 raw inputs, zero-padded in front for a shorter prompt;
    its state is the scan's final state."""
    state_dtype = cfg.ssm_torch_dtype()
    s = x.shape[1]
    K = cfg.d_conv
    in_proj = C.fsdp_gather(p.in_proj, rules, 0)
    xin, z = torch.split(C.copy_to(x, rules) @ in_proj,
                         in_proj.shape[1] // 2, dim=-1)
    # causal depthwise conv over S, summed tap by tap as the reference does
    xpad = F.pad(xin, (0, 0, K - 1, 0))
    xc = xpad[:, :s] * p.conv_w[0]
    for i in range(1, K):
        xc = xc + xpad[:, i:i + s] * p.conv_w[i]
    xc = F.silu(xc + p.conv_b)

    dt, B_ssm, C_ssm = _ssm_params(p, xc, cfg, rules)
    if cfg.ssm_impl == "kernel_proxy":
        xf = xc.float()
        mix = torch.einsum("bsn,bsn->bs", B_ssm, C_ssm)
        y = xf * dt * mix[..., None] + p.D * xf
        state = xf.new_zeros(x.shape[0], xf.shape[-1], cfg.ssm_state)
    else:
        A = -torch.exp(p.A_log)
        y, state = ops.mamba_scan(xc.float().contiguous(), dt.contiguous(),
                                  A, B_ssm.contiguous(), C_ssm.contiguous(),
                                  p.D, chunk or cfg.mamba_chunk,
                                  return_state=True, state_dtype=state_dtype)
    y = (y * F.silu(z.float())).to(x.dtype)
    out = C.reduce_from(y @ C.fsdp_gather(p.out_proj, rules, 1), rules)
    if not return_cache:
        return out, None
    # xpad has S + K - 1 rows: from S on, the last K - 1 inputs (a copy,
    # so that the cache does not hold all of xpad)
    return out, MambaCache(conv=xpad[:, s:].clone(), state=state)


def decode_mamba(p: Mamba, x: torch.Tensor, cache: MambaCache,
                 cfg: ModelConfig, rules=REPLICATED):
    """One-token decode, the reference's plain recurrence.  x (B, 1, d)
    -> (y (B, 1, d), a new ``MambaCache``)."""
    in_proj = C.fsdp_gather(p.in_proj, rules, 0)
    xin, z = torch.split((x @ in_proj)[:, 0], in_proj.shape[1] // 2, dim=-1)
    window = torch.cat([cache.conv, xin[:, None, :]], dim=1)  # (B, K, di)
    xc = torch.einsum("bkd,kd->bd", window, p.conv_w)
    xc = F.silu(xc + p.conv_b)

    dt, B_ssm, C_ssm = _ssm_params(p, xc, cfg, rules)   # (B, di), (B, N)
    A = -torch.exp(p.A_log)
    xf = xc.float()
    decay = torch.exp(dt[..., None] * A[None])                # (B, di, N)
    state = decay * cache.state + (dt * xf)[..., None] * B_ssm[:, None, :]
    y = torch.einsum("bdn,bn->bd", state, C_ssm) + p.D * xf
    y = (y * F.silu(z.float())).to(x.dtype)
    out = C.reduce_from(y @ C.fsdp_gather(p.out_proj, rules, 1), rules)
    return out[:, None, :], MambaCache(conv=window[:, 1:], state=state)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None, d_inner: Optional[int] = None
                     ) -> MambaCache:
    di = cfg.d_inner if d_inner is None else d_inner
    return MambaCache(
        conv=torch.zeros(batch, cfg.d_conv - 1, di, dtype=dtype,
                         device=device),
        state=torch.zeros(batch, di, cfg.ssm_state,
                          dtype=torch.float32, device=device))


def mamba_cache_axes() -> MambaCache:
    return MambaCache(conv=("batch", None, "tp"),
                      state=("batch", "tp", None))


__all__ = ["Mamba", "MambaCache", "apply_mamba", "decode_mamba",
           "init_mamba_cache", "mamba_cache_axes"]
