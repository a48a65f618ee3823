"""PCA compression of KV caches for long-context serving (port of
``repro.models.kv_compression``).

The head_dim axis of K/V is empirically low-rank for long prompts; the
MANOJAVAM Jacobi engine eigendecomposes the per-head K (and V) covariance
(head_dim x head_dim) and the cache is stored in the top-r eigenbasis:

    K' = K @ Vk   (B, S, KV, r)      memory ratio r / head_dim

Attention against a compressed cache is exact in the retained subspace.
``attention_error`` reports the end-to-end attention-output error so
serving can pick r per layer.

The per-head Gram goes through the ``covariance`` op (on the card the
``covariance`` kernel, batched over the KV heads) and the per-head
eigensolves through the batched Jacobi solver with ``fused=True`` (one
``jacobi_sweep`` call a sweep: ``jacobi_sweep_smem`` for head_dim <= 128).
The reference solves unfused; the fused sweep is bitwise its plain round
loop, and the ``covariance`` op sums in another order than the
reference's einsum (fp32, within the fp32 covariance budget: relative
Frobenius 1e-5).

Every function takes the reference's (B, S, KV, hd) cache layout.  The
port's own ``KVCache`` is head-major, (B, KV, S, hd): pass
``cache.k.transpose(1, 2)`` (a view; the Gram's head-major operand is then
a copy, as it is a cast to fp32 anyway).  ``compress``,
``attention_error`` and ``suggest_rank`` take tensors, which stay where
they are, or arrays, which go to ``device`` (default ``cuda``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from .._device import DeviceLike, as_input
from ..core.pca import evcr_cvcr
from ..kernels import ops
from ..serving.solver import jacobi_eigh_batched


@dataclasses.dataclass(frozen=True)
class KVCompressionConfig:
    rank: int = 32
    sweeps: int = 12


class CompressedKV(NamedTuple):
    k: torch.Tensor        # (B, S, KV, r)
    v: torch.Tensor        # (B, S, KV, r)
    basis_k: torch.Tensor  # (KV, hd, r)
    basis_v: torch.Tensor  # (KV, hd, r)


def _per_head_basis(x: torch.Tensor, rank: int, sweeps: int):
    """x: (B, S, KV, hd) -> ((KV, hd, rank) top-r eigenbasis per head,
    (KV, hd) eigenvalues, descending)."""
    b, s, kv, hd = x.shape
    xf = x.float().permute(2, 0, 1, 3).reshape(kv, b * s, hd)
    gram = ops.covariance(xf) / (b * s)
    res = jacobi_eigh_batched(gram, sweeps=sweeps, pivot="parallel",
                              fused=True)
    return res.eigenvectors[:, :, :rank], res.eigenvalues


def compress(cache_k, cache_v, cfg: KVCompressionConfig,
             device: DeviceLike = None) -> CompressedKV:
    cache_k, cache_v = as_input(cache_k, device), as_input(cache_v, device)
    bk, _ = _per_head_basis(cache_k, cfg.rank, cfg.sweeps)
    bv, _ = _per_head_basis(cache_v, cfg.rank, cfg.sweeps)
    kc = torch.einsum("bskd,kdr->bskr", cache_k.float(), bk)
    vc = torch.einsum("bskd,kdr->bskr", cache_v.float(), bv)
    return CompressedKV(kc.to(cache_k.dtype), vc.to(cache_v.dtype), bk, bv)


def decompress(c: CompressedKV) -> Tuple[torch.Tensor, torch.Tensor]:
    k = torch.einsum("bskr,kdr->bskd", c.k.float(), c.basis_k)
    v = torch.einsum("bskr,kdr->bskd", c.v.float(), c.basis_v)
    return k, v


def attention_compressed(q, c: CompressedKV, scale: float) -> torch.Tensor:
    """q: (B, KV, G, hd) grouped query; attention directly in the
    compressed basis (no decompression of the cache)."""
    qk = torch.einsum("bkgd,kdr->bkgr", q.float(), c.basis_k)
    s = torch.einsum("bkgr,bskr->bkgs", qk, c.k.float()) * scale
    w = torch.softmax(s, dim=-1)
    out_r = torch.einsum("bkgs,bskr->bkgr", w, c.v.float())
    return torch.einsum("bkgr,kdr->bkgd", out_r, c.basis_v)


def attention_exact(q, cache_k, cache_v, scale: float) -> torch.Tensor:
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), cache_k.float()) * scale
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", w, cache_v.float())


def attention_error(q, cache_k, cache_v, cfg: KVCompressionConfig,
                    scale: float, device: DeviceLike = None):
    """Relative L2 error of attention output under compression (a 0-d
    tensor) and the achieved memory ratio.  Serving uses this to pick r per
    layer."""
    q, cache_k, cache_v = (as_input(t, device) for t in (q, cache_k,
                                                         cache_v))
    c = compress(cache_k, cache_v, cfg)
    exact = attention_exact(q, cache_k, cache_v, scale)
    approx = attention_compressed(q, c, scale)
    err = torch.linalg.norm(approx - exact) / torch.linalg.norm(
        exact).clamp_min(1e-12)
    ratio = cfg.rank / cache_k.shape[-1]
    return err, ratio


def suggest_rank(cache_k, coverage: float = 0.99, sweeps: int = 12,
                 device: DeviceLike = None) -> int:
    """Smallest rank whose worst-head CVCR reaches ``coverage``."""
    cache_k = as_input(cache_k, device)
    _, eigs = _per_head_basis(cache_k, cache_k.shape[-1], sweeps)
    _, cvcrs = evcr_cvcr(eigs)
    worst = cvcrs.min(dim=0).values
    return int(torch.argmax((worst >= coverage).to(torch.int32))) + 1
