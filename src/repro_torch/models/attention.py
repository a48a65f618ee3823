"""GQA/MQA/MHA attention with TP head padding and a KV cache (port of
``repro.models.attention``), on the port's flash-attention op.

The reference computes attention in plain ``jnp``: prefill in
``_dense_attention`` or, when S > ``attn_chunk`` and S % ``attn_chunk`` ==
0, in ``_chunked_attention`` (an online softmax over KV chunks); decode in
``decode_attention``, which merges the new token's self-term in closed
form.  Each is the function of the TPU kernel ``flash_attention`` (an
online-softmax causal attention with fp32 m, l and accumulator), so here
every branch calls ``kernels.ops.flash_attention``: on the card that is
``flash_attention_mma`` (bf16 prefill), ``flash_attention_tf32x3`` (fp32
prefill) or ``flash_attention_splitkv`` (decode, Sq <= 16); on the CPU its
plain version.

Cache layout.  ``KVCache`` is head-major, (B, KV, S, hd), contiguous, so a
(B * KV, S, hd) view is the operand the kernels take:

* prefill writes K and V into the cache once (the one permute of the
  step) and, for MHA without head padding, attends straight from the
  cache: its capacity may exceed the prompt, and the causal mask keeps
  every row off the zero tail (the kernels visit only keys up to the
  last row's diagonal); training (no cache asked for) permutes K and V
  into a head-major copy and hands that to the op, so autograd keeps no
  cache;
* an MHA decode step (G = 1) writes the new token's K and V at slot
  ``pos`` and attends the cache in place, with Sq = 1 and ``q_offset =
  pos``: no copy of the cache, and the split-KV kernel reads keys
  0..pos only;
* GQA/MQA (G > 1) folds each KV head's G query heads into G query rows
  of one (b, kv) problem.  Those rows share one position, which the
  causal mask cannot express, so the step copies the visible keys and
  values, ``cache[:, :, :pos + 1]``, into a contiguous (B * KV, pos + 1,
  hd) pair and attends it unmasked: 2 x B x KV x (pos + 1) x hd elements
  copied a layer a step, 1/G of what expanding the KV heads would copy.
  Prefill expands the KV heads to the padded query heads, as the
  reference's ``_expand_kv`` does: one (B, Hp, S, hd) copy of K and of V
  a layer.

The reference's API takes (B, S, KV, hd) caches; ``convert`` maps between
the two layouts for the tests.  The ring-buffer wrap (``pos >= S``) keeps
the reference's result: all S cached slots and the new token (S + 1 keys)
are attended before slot ``pos % S`` is overwritten.

Non-causal attention (whisper's encoder, ``causal=False``) hands the op
exactly the S keys of the sequence: no mask would hide a zero tail, so an
MHA cache of larger capacity is sliced (and copied) to S first.

Cross attention (the encoder-decoder's decoder) attends the encoder's K
and V, projected once a layer by ``cross_kv`` into a head-major
``KVCache`` of capacity ``n_frames`` that no step writes:

* prefill (``cross_attention``): the decoder's queries over all F keys,
  non-causal, in one op call: a KV head's G query heads as G x Sq rows
  over the (B * KV, F, hd) view (no copy), or, with padded heads, (B *
  Hp, Sq, hd) over the expanded KV heads;
* decode (``decode_attention(..., cross=True)``): one query row a head,
  G rows a KV head over the (B * KV, F, hd) view itself (every key is
  visible, so no copy and no mask).

As in the reference, the prefill form adds no bias to q, k or v, the
decode form adds ``bq`` to q, and neither rotates.  Ring attention raises
until the multi-device slice.

Where gradients flow, the op's backward (``kernels.grad``) runs over KV
chunks of ``cfg.attn_chunk``, which every full-sequence call passes.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..kernels import ops
from .config import ModelConfig
from .layers import _normal, _param, apply_rope


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, KV, S, hd), head-major, contiguous
    v: torch.Tensor  # (B, KV, S, hd)


def _unsupported(cfg: ModelConfig) -> None:
    if cfg.attn_impl == "ring":
        raise NotImplementedError(
            "ring attention (parallel/ring_attention.py) is not ported: it "
            "comes with the LM half of the multi-device work (ROADMAP "
            "queue 1, item 4b)")


class Attention(nn.Module):
    """``wq`` (d, Hp, hd) with the padded heads' slice zero, ``wk``/``wv``
    (d, KV, hd), ``wo`` (Hp, hd, d); with ``qkv_bias`` also ``bq`` (Hp,
    hd) and ``bk``/``bv`` (KV, hd)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = cfg.torch_dtype()
        d, hd = cfg.d_model, cfg.head_dim
        H, KV = cfg.padded_heads, cfg.n_kv_heads
        self.cfg = cfg

        def empty(*shape):
            return _param(torch.empty(shape, dtype=dt, device=device))

        self.wq, self.wk, self.wv = empty(d, H, hd), empty(d, KV, hd), \
            empty(d, KV, hd)
        self.wo = empty(H, hd, d)
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = empty(H, hd), empty(KV, hd), \
                empty(KV, hd)

    def reset_parameters(self, gen: Optional[torch.Generator]) -> None:
        cfg, dev = self.cfg, self.wq.device
        sq = 1.0 / math.sqrt(cfg.d_model)
        for w, scale in ((self.wq, sq), (self.wk, sq), (self.wv, sq),
                         (self.wo, 1.0 / math.sqrt(cfg.padded_heads
                                                   * cfg.head_dim))):
            w.copy_(_normal(gen, w.shape, w.dtype, scale, dev))
        # zero the padded head slice (exactness: their output is masked)
        self.wq[:, cfg.n_heads:, :] = 0
        if cfg.qkv_bias:
            for b in (self.bq, self.bk, self.bv):
                b.zero_()


def init_attention(cfg: ModelConfig, device=None,
                   generator: Optional[torch.Generator] = None,
                   cross: bool = False) -> Attention:
    """Self attention or, with ``cross``, a decoder's cross attention: the
    same leaves and draws (the reference's ``init_attention``)."""
    attn = Attention(cfg, device)
    with torch.no_grad():
        attn.reset_parameters(generator)
    return attn


def _kv_map(cfg: ModelConfig) -> np.ndarray:
    """query-head -> kv-head index (padded heads clamp to the last group)."""
    g = cfg.group_size
    return np.minimum(np.arange(cfg.padded_heads) // g, cfg.n_kv_heads - 1)


def _head_mask(cfg: ModelConfig, dtype, device) -> torch.Tensor:
    """(1, Hp, 1, 1): 1 on the true heads, 0 on the padded ones (the
    head-major counterpart of the reference's (1, 1, Hp, 1))."""
    m = (torch.arange(cfg.padded_heads, device=device) < cfg.n_heads)
    return m.to(dtype)[None, :, None, None]


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor):
    """q (B, S, Hp, hd), k, v (B, S, KV, hd), biased and, with rope,
    rotated."""
    q, k, v = _project(x, p.wq), _project(x, p.wk), _project(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(kv: torch.Tensor, cfg: ModelConfig, s: int,
               causal: bool = True) -> torch.Tensor:
    """(B, KV, cap, hd) cache -> (B * Hp, S, hd): the true KV heads
    replicated into the padded query-head layout (a copy), or, where that
    layout is the cache's own (MHA, no padded heads), the cache itself:
    at its full capacity when causal (no copy; the mask hides the tail),
    else its first S slots (a copy unless cap == S)."""
    b, kvh, cap, hd = kv.shape
    if cfg.padded_heads == kvh:
        if causal or cap == s:
            return kv.view(b * kvh, cap, hd)
        return kv[:, :, :s].contiguous().view(b * kvh, s, hd)
    idx = torch.as_tensor(_kv_map(cfg), device=kv.device)
    return kv[:, idx, :s].contiguous().view(b * cfg.padded_heads, s, hd)


def _out_proj(p: Attention, out: torch.Tensor, cfg: ModelConfig):
    """(B * Hp, S, hd) attention output -> (B, S, d): the padded heads
    masked, then ``wo``."""
    hp, hd = cfg.padded_heads, cfg.head_dim
    out = out.view(-1, hp, out.shape[1], hd)
    if hp > cfg.n_heads:
        out = out * _head_mask(cfg, out.dtype, out.device)
    b, _, s, _ = out.shape
    return out.transpose(1, 2).reshape(b, s, hp * hd) @ p.wo.reshape(
        hp * hd, -1)


def self_attention(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, *, causal: bool = True,
                   return_cache: bool = False,
                   cache_len: Optional[int] = None):
    """Train / prefill self-attention over the full sequence x (B, S, d),
    causal or (an encoder's) not.  Returns (y, cache): with
    ``return_cache`` a head-major ``KVCache`` of capacity ``cache_len``
    (default S; slots past S are zero), else None.  The reference's
    ``chunk`` argument picks between its dense and chunked versions of one
    function; the flash op computes that function at every length, so the
    port has no such argument."""
    _unsupported(cfg)
    b, s, _ = x.shape
    hp, hd = cfg.padded_heads, cfg.head_dim
    q, k, v = _qkv(p, x, cfg, positions)
    if return_cache:
        cache = init_cache(cfg, b, max(cache_len or s, s), k.dtype, k.device)
        cache.k[:, :, :s] = k.transpose(1, 2)
        cache.v[:, :, :s] = v.transpose(1, 2)
    else:
        cache = KVCache(k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous())
    qh = q.transpose(1, 2).reshape(b * hp, s, hd)
    kx = _expand_kv(cache.k, cfg, s, causal)
    vx = _expand_kv(cache.v, cfg, s, causal)
    out = ops.flash_attention(qh, kx, vx, causal=causal, scale=hd ** -0.5,
                              chunk=cfg.attn_chunk)
    return _out_proj(p, out, cfg), (cache if return_cache else None)


def cross_kv(p: Attention, enc_out: torch.Tensor) -> KVCache:
    """The encoder output (B, F, d) projected by a decoder layer's cross
    ``wk`` and ``wv`` (no bias, as the reference) into a head-major
    ``KVCache`` (B, KV, F, hd)."""
    return KVCache(_project(enc_out, p.wk).transpose(1, 2).contiguous(),
                   _project(enc_out, p.wv).transpose(1, 2).contiguous())


def cross_attention(p: Attention, x: torch.Tensor, enc_kv: KVCache,
                    cfg: ModelConfig) -> torch.Tensor:
    """Decoder -> encoder attention of x (B, Sq, d) over ``enc_kv`` (B, KV,
    F, hd): non-causal over all F keys, q unbiased and unrotated (the
    reference's prefill form).  Without padded heads a KV head's G query
    heads are G x Sq rows of one problem over the cache view (no copy);
    padded heads take the expanded KV heads.  Returns y (B, Sq, d)."""
    _unsupported(cfg)
    b, sq, _ = x.shape
    hp, hd = cfg.padded_heads, cfg.head_dim
    kvh, f = enc_kv.k.shape[1], enc_kv.k.shape[2]
    qh = _project(x, p.wq).transpose(1, 2).contiguous()   # (B, Hp, Sq, hd)
    if hp == cfg.n_heads:
        k = enc_kv.k.view(b * kvh, f, hd)
        v = enc_kv.v.view(b * kvh, f, hd)
        qh = qh.view(b * kvh, hp // kvh * sq, hd)
    else:
        k = _expand_kv(enc_kv.k, cfg, f, causal=False)
        v = _expand_kv(enc_kv.v, cfg, f, causal=False)
        qh = qh.view(b * hp, sq, hd)
    out = ops.flash_attention(qh, k, v, causal=False, scale=hd ** -0.5,
                              chunk=cfg.attn_chunk)
    return _out_proj(p, out.view(b * hp, sq, hd), cfg)


def _cross_decode(p: Attention, x: torch.Tensor, cache: KVCache,
                  cfg: ModelConfig):
    """One query row a head over the static encoder cache, q with ``bq``
    and unrotated (the reference's ``decode_attention(cross=True)``)."""
    b = x.shape[0]
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    h, g = cfg.n_heads, cfg.group_size
    f = cache.k.shape[2]
    q = _project(x, p.wq)[:, :, :h]
    if cfg.qkv_bias:
        q = q + p.bq[:h]
    out = ops.flash_attention(
        q.reshape(b * kvh, g, hd), cache.k.view(b * kvh, f, hd),
        cache.v.view(b * kvh, f, hd), causal=False, scale=hd ** -0.5)
    return out.reshape(b, 1, h * hd) @ p.wo[:h].reshape(h * hd, -1), cache


def decode_attention(p: Attention, x: torch.Tensor, cache: KVCache, pos: int,
                     cfg: ModelConfig, *, cross: bool = False):
    """One-token decode: x (B, 1, d) at position ``pos`` (a host int)
    against ``cache`` (B, KV, S, hd).  Writes the new token's K and V into
    the cache IN PLACE (slot ``pos``, or ``pos % S`` after the wrap) and
    returns (y, cache): the cache tensors are the caller's, updated.  With
    ``cross`` the cache is the encoder's, attended whole and not written
    (``pos`` unused)."""
    _unsupported(cfg)
    if cross:
        return _cross_decode(p, x, cache, cfg)
    b = x.shape[0]
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    h, g = cfg.n_heads, cfg.group_size
    s = cache.k.shape[2]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, positions)
    q = q[:, :, :h]                                      # true heads
    scale = hd ** -0.5
    if pos < s:
        cache.k[:, :, pos] = k_new[:, 0]
        cache.v[:, :, pos] = v_new[:, 0]
        if g == 1:  # MHA: the cache in place, keys 0..pos
            out = ops.flash_attention(
                q.reshape(b * h, 1, hd), cache.k.view(b * kvh, s, hd),
                cache.v.view(b * kvh, s, hd), causal=True, scale=scale,
                q_offset=pos)
        else:       # G query rows a KV head over a copy of keys 0..pos
            n = pos + 1
            out = ops.flash_attention(
                q.reshape(b * kvh, g, hd),
                cache.k[:, :, :n].contiguous().view(b * kvh, n, hd),
                cache.v[:, :, :n].contiguous().view(b * kvh, n, hd),
                causal=False, scale=scale)
    else:
        # the reference's wrap: all S slots and the new token, then the
        # write of slot pos % S
        k_all = torch.cat([cache.k, k_new.transpose(1, 2)], dim=2)
        v_all = torch.cat([cache.v, v_new.transpose(1, 2)], dim=2)
        out = ops.flash_attention(
            q.reshape(b * kvh, g, hd), k_all.view(b * kvh, s + 1, hd),
            v_all.view(b * kvh, s + 1, hd), causal=False, scale=scale)
        cache.k[:, :, pos % s] = k_new[:, 0]
        cache.v[:, :, pos % s] = v_new[:, 0]
    y = out.reshape(b, 1, h * hd) @ p.wo[:h].reshape(h * hd, -1)
    return y, cache


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype,
               device=None) -> KVCache:
    shape = (batch, cfg.n_kv_heads, seq, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
