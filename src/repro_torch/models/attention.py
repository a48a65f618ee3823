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
decode form adds ``bq`` to q, and neither rotates.

On a mesh (``rules``; ``REPLICATED`` by default):

* train and prefill are head-parallel over "model": this rank's Hp / tp
  query heads (its ``wq``/``bq``/``wo`` slices) on the flash op, the KV
  heads they read expanded from the whole K and V (``wk``/``wv`` are
  replicated over "model", so K and V pass ``copy_to``: their gradient is
  a partial share on each rank and is summed), the partial output of
  ``wo`` all-reduced;
* the prefill cache is sharded on the sequence ("seq_tp": "model", and
  the batch axes too with ``seq_over_data``): each rank keeps its block
  of the capacity, rounded up to a multiple of the shards;
* decode over such a cache: where "seq_tp" spans one rank it is the
  split-KV route above; where it spans more, every rank projects every
  true query head (``wq`` gathered whole), attends its block of the
  cache, and the softmax is merged across ranks as the reference's
  distributed softmax does (an all-reduce of the max, then one of the
  denominators and numerators), the new token's self-term added once
  after the merge; the slot ``pos % S`` is written by the rank that owns
  it; the output goes through this rank's heads of ``wo`` and an
  all-reduce;
* cross attention is head-parallel too; the encoder's K/V cache is whole
  on the sequence;
* ``attn_impl="ring"`` shards the sequence instead
  (``parallel.ring_attention``): the attention weights are replicated
  over "model" and pass ``copy_to`` (each rank's tokens give a partial
  share of their gradient), the sequence is sliced to this rank's block
  and the output blocks gathered back.  Without a mesh a ring config runs
  the path above (its heads are not padded).

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
from ..parallel import collectives as C
from ..parallel.sharding import REPLICATED, pad_to_multiple
from .config import ModelConfig
from .layers import NEG_INF, _normal, _param, apply_rope


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, KV, S, hd), head-major, contiguous
    v: torch.Tensor  # (B, KV, S, hd)


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

    def roles(self) -> dict:
        """The reference's: heads over "model" unless the sequence is
        (ring); K and V replicated over "model"."""
        h = None if self.cfg.attn_impl == "ring" else "tp"
        return {"wq": ("fsdp", h, None), "wk": ("fsdp", None, None),
                "wv": ("fsdp", None, None), "wo": (h, None, "fsdp"),
                "bq": (h, None), "bk": (None, None), "bv": (None, None)}

    def reset_parameters(self, gen: Optional[torch.Generator]) -> None:
        cfg = self.cfg
        sq = 1.0 / math.sqrt(cfg.d_model)
        for w, scale in ((self.wq, sq), (self.wk, sq), (self.wv, sq),
                         (self.wo, 1.0 / math.sqrt(cfg.padded_heads
                                                   * cfg.head_dim))):
            _normal(gen, w, scale)
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


def _head_mask(cfg: ModelConfig, dtype, device, h0: int = 0,
               hl: Optional[int] = None) -> torch.Tensor:
    """(1, hl, 1, 1): 1 on the true heads among heads h0 .. h0 + hl, 0 on
    the padded ones (the head-major counterpart of the reference's (1, 1,
    Hp, 1))."""
    hl = cfg.padded_heads if hl is None else hl
    m = (torch.arange(h0, h0 + hl, device=device) < cfg.n_heads)
    return m.to(dtype)[None, :, None, None]


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


class _Weights(NamedTuple):
    """A layer's attention weights with their "fsdp" dim gathered."""
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    bq: Optional[torch.Tensor]
    bk: Optional[torch.Tensor]
    bv: Optional[torch.Tensor]


def _weights(p: Attention, rules) -> _Weights:
    def g(w, d):
        return C.fsdp_gather(w, rules, d)
    b = p.cfg.qkv_bias
    return _Weights(g(p.wq, 0), g(p.wk, 0), g(p.wv, 0), g(p.wo, 2),
                    p.bq if b else None, p.bk if b else None,
                    p.bv if b else None)


def _head_role(cfg: ModelConfig) -> Optional[str]:
    return None if cfg.attn_impl == "ring" else "tp"


def _heads(cfg: ModelConfig, w: _Weights, rules):
    """(h0, hl): this rank's first query head and its number of heads."""
    hl = w.wq.shape[1]
    return rules.index(_head_role(cfg)) * hl, hl


def _qkv(w: _Weights, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor, rules=REPLICATED):
    """q (B, S, hl, hd) of this rank's heads, k, v (B, S, KV, hd), biased
    and, with rope, rotated; K and V enter the head-parallel region by
    ``copy_to``."""
    q = _project(C.copy_to(x, rules), w.wq)
    k, v = _project(x, w.wk), _project(x, w.wv)
    if cfg.qkv_bias:
        q, k, v = q + w.bq, k + w.bk, v + w.bv
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, C.copy_to(k, rules), C.copy_to(v, rules)


def _expand_kv(kv: torch.Tensor, cfg: ModelConfig, s: int,
               causal: bool = True, h0: int = 0,
               hl: Optional[int] = None) -> torch.Tensor:
    """(B, KV, cap, hd) cache -> (B * hl, S, hd): the KV heads of query
    heads h0 .. h0 + hl (default all Hp) replicated into the padded
    query-head layout (a copy), or, where that layout is the cache's own
    (MHA, every head here, none padded), the cache itself: at its full
    capacity when causal (no copy; the mask hides the tail), else its
    first S slots (a copy unless cap == S)."""
    b, kvh, cap, hd = kv.shape
    hl = cfg.padded_heads if hl is None else hl
    if hl == cfg.padded_heads == kvh:
        if causal or cap == s:
            return kv.view(b * kvh, cap, hd)
        return kv[:, :, :s].contiguous().view(b * kvh, s, hd)
    idx = torch.as_tensor(_kv_map(cfg)[h0:h0 + hl], device=kv.device)
    return kv[:, idx, :s].contiguous().view(b * hl, s, hd)


def _out_proj(out: torch.Tensor, cfg: ModelConfig, wo: torch.Tensor,
              h0: int = 0, rules=REPLICATED, role: Optional[str] = "tp"):
    """(B * hl, S, hd) attention output of heads h0 .. h0 + hl -> (B, S,
    d): the padded heads masked, then ``wo``'s rows of those heads, the
    partial sums all-reduced over ``role``'s axes."""
    hl, hd = wo.shape[0], cfg.head_dim
    out = out.view(-1, hl, out.shape[1], hd)
    if h0 + hl > cfg.n_heads:
        out = out * _head_mask(cfg, out.dtype, out.device, h0, hl)
    b, _, s, _ = out.shape
    y = out.transpose(1, 2).reshape(b, s, hl * hd) @ wo.reshape(hl * hd, -1)
    return C.reduce_from(y, rules, role)


def _ring(cfg: ModelConfig, rules) -> bool:
    return (cfg.attn_impl == "ring" and rules.mesh is not None
            and rules.size("seq_tp") > 1)


def _local_cache(kv: KVCache, cap: int, rules) -> KVCache:
    """This rank's block of a cache of capacity ``cap`` (rounded up to a
    multiple of the "seq_tp" shards) holding ``kv``'s S slots (B, KV, S,
    hd), the rest zero."""
    n, r = rules.size("seq_tp"), rules.index("seq_tp")
    b, kvh, s, hd = kv.k.shape
    sl = pad_to_multiple(max(cap, s), n) // n
    out = init_cache_shape(b, kvh, sl, hd, kv.k.dtype, kv.k.device)
    lo, hi = r * sl, min((r + 1) * sl, s)
    if hi > lo:
        out.k[:, :, :hi - lo] = kv.k[:, :, lo:hi]
        out.v[:, :, :hi - lo] = kv.v[:, :, lo:hi]
    return out


def self_attention(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, *, causal: bool = True,
                   return_cache: bool = False,
                   cache_len: Optional[int] = None, rules=REPLICATED):
    """Train / prefill self-attention over the full sequence x (B, S, d),
    causal or (an encoder's) not.  Returns (y, cache): with
    ``return_cache`` a head-major ``KVCache`` of capacity ``cache_len``
    (default S; slots past S are zero; on a mesh this rank's block of the
    sequence), else None.  The reference's ``chunk`` argument picks
    between its dense and chunked versions of one function; the flash op
    computes that function at every length, so the port has no such
    argument."""
    if _ring(cfg, rules):
        return _ring_self_attention(p, x, cfg, positions, causal,
                                    return_cache, cache_len, rules)
    b, s, _ = x.shape
    hd = cfg.head_dim
    w = _weights(p, rules)
    h0, hl = _heads(cfg, w, rules)
    q, k, v = _qkv(w, x, cfg, positions, rules)
    if return_cache and rules.size("seq_tp") == 1:
        cache = init_cache(cfg, b, max(cache_len or s, s), k.dtype, k.device)
        cache.k[:, :, :s] = k.transpose(1, 2)
        cache.v[:, :, :s] = v.transpose(1, 2)
        kv = cache
    else:
        kv = KVCache(k.transpose(1, 2).contiguous(),
                     v.transpose(1, 2).contiguous())
        cache = (_local_cache(kv, cache_len or s, rules) if return_cache
                 else None)
    # contiguous at B == 1 too, where the reshape is a strided view
    qh = q.transpose(1, 2).reshape(b * hl, s, hd).contiguous()
    kx = _expand_kv(kv.k, cfg, s, causal, h0, hl)
    vx = _expand_kv(kv.v, cfg, s, causal, h0, hl)
    out = ops.flash_attention(qh, kx, vx, causal=causal, scale=hd ** -0.5,
                              chunk=cfg.attn_chunk)
    return _out_proj(out, cfg, w.wo, h0, rules), cache


def _ring_self_attention(p: Attention, x, cfg: ModelConfig, positions,
                         causal: bool, return_cache: bool,
                         cache_len: Optional[int], rules):
    """Sequence-parallel self attention (the reference's ``attn_impl ==
    "ring"`` branch): this rank's block of the sequence, the true K/V
    heads rotating around the "seq_tp" ring."""
    from ..parallel.ring_attention import ring_attention
    b, s, _ = x.shape
    hd, n = cfg.head_dim, rules.size("seq_tp")
    if s % n:
        raise ValueError(f"ring attention: {s} tokens do not split into "
                         f"{n} blocks")
    sl, r = s // n, rules.index("seq_tp")

    def g(w, d):   # replicated over the ring: a partial gradient a rank
        return C.copy_to(C.fsdp_gather(w, rules, d), rules, "seq_tp")
    xl = C.seq_scatter(x, rules, 1)
    q, k, v = (_project(xl, g(p.wq, 0)), _project(xl, g(p.wk, 0)),
               _project(xl, g(p.wv, 0)))
    if cfg.qkv_bias:
        q = q + C.copy_to(p.bq, rules, "seq_tp")
        k = k + C.copy_to(p.bk, rules, "seq_tp")
        v = v + C.copy_to(p.bv, rules, "seq_tp")
    if cfg.pos_embed == "rope":
        pl = positions[:, r * sl:(r + 1) * sl]
        q = apply_rope(q, pl, cfg.rope_theta)
        k = apply_rope(k, pl, cfg.rope_theta)
    out = ring_attention(q, k, v, rules.mesh, seq_axis=rules.axis("seq_tp"),
                         causal=causal, scale=hd ** -0.5)
    wo = g(p.wo, 2)
    y = out.reshape(b, sl, -1) @ wo.reshape(-1, wo.shape[-1])
    y = C.seq_gather(y, rules, 1)
    cache = None
    if return_cache:
        kf = C.role_all_gather(k, rules, "seq_tp", 1)
        vf = C.role_all_gather(v, rules, "seq_tp", 1)
        cache = _local_cache(KVCache(kf.transpose(1, 2).contiguous(),
                                     vf.transpose(1, 2).contiguous()),
                             cache_len or s, rules)
    return y, cache


def cross_kv(p: Attention, enc_out: torch.Tensor,
             rules=REPLICATED) -> KVCache:
    """The encoder output (B, F, d) projected by a decoder layer's cross
    ``wk`` and ``wv`` (no bias, as the reference) into a head-major
    ``KVCache`` (B, KV, F, hd), whole on the sequence."""
    k = C.copy_to(_project(enc_out, C.fsdp_gather(p.wk, rules, 0)), rules)
    v = C.copy_to(_project(enc_out, C.fsdp_gather(p.wv, rules, 0)), rules)
    return KVCache(k.transpose(1, 2).contiguous(),
                   v.transpose(1, 2).contiguous())


def cross_attention(p: Attention, x: torch.Tensor, enc_kv: KVCache,
                    cfg: ModelConfig, rules=REPLICATED) -> torch.Tensor:
    """Decoder -> encoder attention of x (B, Sq, d) over ``enc_kv`` (B, KV,
    F, hd): non-causal over all F keys, q unbiased and unrotated (the
    reference's prefill form).  With every head here and none padded a KV
    head's G query heads are G x Sq rows of one problem over the cache
    view (no copy); otherwise the heads take the expanded KV heads.
    Returns y (B, Sq, d)."""
    b, sq, _ = x.shape
    hd = cfg.head_dim
    w = _weights(p, rules)
    h0, hl = _heads(cfg, w, rules)
    kvh, f = enc_kv.k.shape[1], enc_kv.k.shape[2]
    qh = _project(C.copy_to(x, rules), w.wq).transpose(1, 2).contiguous()
    if hl == cfg.padded_heads == cfg.n_heads:
        k = enc_kv.k.view(b * kvh, f, hd)
        v = enc_kv.v.view(b * kvh, f, hd)
        qh = qh.view(b * kvh, hl // kvh * sq, hd)
    else:
        k = _expand_kv(enc_kv.k, cfg, f, False, h0, hl)
        v = _expand_kv(enc_kv.v, cfg, f, False, h0, hl)
        qh = qh.view(b * hl, sq, hd)
    out = ops.flash_attention(qh, k, v, causal=False, scale=hd ** -0.5,
                              chunk=cfg.attn_chunk)
    return _out_proj(out.view(b * hl, sq, hd), cfg, w.wo, h0, rules)


def _cross_decode(p: Attention, x: torch.Tensor, cache: KVCache,
                  cfg: ModelConfig, rules=REPLICATED):
    """One query row a head over the static encoder cache, q with ``bq``
    and unrotated (the reference's ``decode_attention(cross=True)``);
    head-parallel on a mesh."""
    b = x.shape[0]
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    h, g = cfg.n_heads, cfg.group_size
    f = cache.k.shape[2]
    w = _weights(p, rules)
    h0, hl = _heads(cfg, w, rules)
    if hl == cfg.padded_heads:
        q = _project(x, w.wq)[:, :, :h]
        if cfg.qkv_bias:
            q = q + w.bq[:h]
        out = ops.flash_attention(
            q.reshape(b * kvh, g, hd), cache.k.view(b * kvh, f, hd),
            cache.v.view(b * kvh, f, hd), causal=False, scale=hd ** -0.5)
        return (out.reshape(b, 1, h * hd) @ w.wo[:h].reshape(h * hd, -1),
                cache)
    q = _project(x, w.wq)
    if cfg.qkv_bias:
        q = q + w.bq
    k = _expand_kv(cache.k, cfg, f, False, h0, hl)
    v = _expand_kv(cache.v, cfg, f, False, h0, hl)
    out = ops.flash_attention(q.reshape(b * hl, 1, hd), k, v, causal=False,
                              scale=hd ** -0.5)
    return _out_proj(out.view(b * hl, 1, hd), cfg, w.wo, h0, rules), cache


def decode_attention(p: Attention, x: torch.Tensor, cache: KVCache, pos: int,
                     cfg: ModelConfig, *, cross: bool = False,
                     rules=REPLICATED):
    """One-token decode: x (B, 1, d) at position ``pos`` (a host int)
    against ``cache`` (B, KV, S, hd; on a mesh this rank's block of the
    sequence).  Writes the new token's K and V into the cache IN PLACE
    (slot ``pos``, or ``pos % S`` after the wrap) and returns (y, cache):
    the cache tensors are the caller's, updated.  With ``cross`` the cache
    is the encoder's, attended whole and not written (``pos`` unused)."""
    if cross:
        return _cross_decode(p, x, cache, cfg, rules)
    if rules.size("seq_tp") > 1:
        return _sharded_decode(p, x, cache, pos, cfg, rules)
    b = x.shape[0]
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    h, g = cfg.n_heads, cfg.group_size
    s = cache.k.shape[2]
    w = _weights(p, rules)
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _qkv(w, x, cfg, positions)
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
    y = out.reshape(b, 1, h * hd) @ w.wo[:h].reshape(h * hd, -1)
    return y, cache


def _sharded_decode(p: Attention, x: torch.Tensor, cache: KVCache, pos: int,
                    cfg: ModelConfig, rules):
    """Decode over a cache sharded on the sequence: the reference's
    distributed softmax (``src/repro/models/attention.py:203-262``) with
    the reductions over "seq_tp" issued here."""
    b = x.shape[0]
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    h, g = cfg.n_heads, cfg.group_size
    role = _head_role(cfg)
    w = _weights(p, rules)
    h0, hl = _heads(cfg, w, rules)
    wq = C.role_all_gather(w.wq, rules, role, 1)           # every head
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q = _project(x, wq)[:, :, :h]
    k_new, v_new = _project(x, w.wk), _project(x, w.wv)
    if cfg.qkv_bias:
        q = q + C.role_all_gather(w.bq, rules, role, 0)[:h]
        k_new, v_new = k_new + w.bk, v_new + w.bv
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    scale = hd ** -0.5
    qg = q.reshape(b, kvh, g, hd).float()
    kc, vc = cache.k.float(), cache.v.float()            # (B, KV, sl, hd)
    sl, r = kc.shape[2], rules.index("seq_tp")
    s_cache = torch.einsum("bkgd,bksd->bkgs", qg, kc) * scale
    valid = (r * sl + torch.arange(sl, device=x.device)) < pos
    s_cache = torch.where(valid, s_cache, torch.full_like(s_cache, NEG_INF))
    s_self = torch.einsum("bkgd,bkd->bkg", qg, k_new[:, 0].float()) * scale
    m = torch.maximum(C.role_all_reduce(s_cache.amax(-1), rules, "seq_tp",
                                        "max"), s_self)
    e_cache = torch.exp(s_cache - m[..., None])
    e_self = torch.exp(s_self - m)
    part = torch.cat([e_cache.sum(-1)[..., None],
                      torch.einsum("bkgs,bksd->bkgd", e_cache, vc)], -1)
    part = C.role_all_reduce(part, rules, "seq_tp")
    denom = part[..., 0] + e_self                        # the self-term once
    num = part[..., 1:] + e_self[..., None] * v_new[:, 0].float()[:, :, None]
    out = (num / denom[..., None]).reshape(b, 1, h, hd).to(x.dtype)
    slot = pos % (sl * rules.size("seq_tp"))              # ring-buffer write
    if slot // sl == r:
        cache.k[:, :, slot - r * sl] = k_new[:, 0]
        cache.v[:, :, slot - r * sl] = v_new[:, 0]
    if cfg.padded_heads > h:
        out = torch.nn.functional.pad(out, (0, 0, 0, cfg.padded_heads - h))
    out = out[:, :, h0:h0 + hl]
    y = out.reshape(b, 1, hl * hd) @ w.wo.reshape(hl * hd, -1)
    return C.role_all_reduce(y, rules, role), cache


def init_cache_shape(batch: int, kv_heads: int, seq: int, head_dim: int,
                     dtype, device=None) -> KVCache:
    shape = (batch, kv_heads, seq, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype,
               device=None) -> KVCache:
    return init_cache_shape(batch, cfg.n_kv_heads, seq, cfg.head_dim, dtype,
                            device)


def cache_axes() -> KVCache:
    """The roles of a head-major cache's dims (B, KV, S, hd)."""
    ax = ("batch", None, "seq_tp", None)
    return KVCache(ax, ax)
