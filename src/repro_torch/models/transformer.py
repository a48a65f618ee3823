"""The transformer stack (port of ``repro.models.transformer``) for the
dense, moe, ssm and hybrid families: ``init_model``, ``forward`` (modes
``prefill`` and ``train``, forward only), ``prefill``, ``decode_step``,
``DecodeState`` and ``make_decode_state``.

A layer's mixer is attention or ``Mamba`` and its FFN an ``MLP`` or a
``MoE`` (with arctic's dense residual ``mlp_res`` or llama4's shared
expert ``mlp_shared``), by ``cfg.layer_kinds()`` and ``cfg.ffn_kinds()``;
``d_ff == 0`` (falcon-mamba) means no FFN.  The reference stacks each
period of layers (``period``) into groups and scans over them; here the
layers are an ``nn.ModuleList`` run in order, and the decode state holds
one cache a layer: a head-major ``KVCache`` (``attention``'s module
docstring) or a ``MambaCache``.  ``scan_layers`` and ``remat`` stay
config fields with no effect on the result.  encdec and vlm configs, ring
attention and learned positions raise ``NotImplementedError`` naming the
ROADMAP item that ports them.

Prefill returns the last position's logits and, to keep memory at the
size of one row, unembeds only that position: (B, d) @ (d, vocab) gives
the same values as the reference's full (B, S, vocab) logits sliced at
-1 (at olmo-1b's B 4 x S 4096 x 50304 those would be 1.65 GB in bf16).
``forward`` keeps the reference's full logits and returns the MoE layers'
summed load-balance ``aux``.

Everything runs under ``torch.no_grad()``; ``decode_step`` writes the new
token's K and V into the state's KV caches in place (JAX's
``donate_argnums`` in the reference's serve loop) and replaces each
``MambaCache``, so a state is consumed by the step that takes it.
"""
from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional, Union

import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from . import attention as attn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from .config import ModelConfig
from .layers import Embedding, MLP, Norm

# the ROADMAP item that ports each family this port leaves out
_DEFERRED = {
    "encdec": "encdec (the encoder and cross attention): ROADMAP queue 1, "
              "item 2",
    "vlm": "vlm (the patch prefix): ROADMAP queue 1, item 2",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not serve yet: the encdec and vlm
    families, ring attention, learned positions (whisper's, with its
    encoder), and the scan options ``mamba`` raises for."""
    if cfg.family in _DEFERRED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; "
            f"{_DEFERRED[cfg.family]}")
    if cfg.pos_embed != "rope":
        raise NotImplementedError(
            f"{cfg.name}: pos_embed {cfg.pos_embed!r} comes with the "
            f"encoder-decoder slice (ROADMAP queue 1, item 2)")
    attn_mod._unsupported(cfg)
    if "mamba" in cfg.layer_kinds():
        mamba_mod._unsupported(cfg)


def period(cfg: ModelConfig) -> int:
    """Layers a group of the reference's stack: lcm(attn_every (hybrid),
    moe_every (with experts))."""
    p = cfg.attn_every if cfg.family == "hybrid" else 1
    if cfg.n_experts:
        p = math.lcm(p, cfg.moe_every)
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of the period {p}")
    return p


class Block(nn.Module):
    """norm1 -> mixer (attention or ``Mamba``) -> residual; norm2 -> FFN
    (``MLP``, or ``MoE`` with ``mlp_res`` / ``mlp_shared``) -> residual."""

    def __init__(self, cfg: ModelConfig, mixer: str, ffn: str, device=None):
        super().__init__()
        self.mixer_kind, self.ffn_kind = mixer, ffn
        self.norm1 = Norm(cfg, device)
        self.mixer = (attn_mod.Attention(cfg, device) if mixer == "attn"
                      else mamba_mod.Mamba(cfg, device))
        if cfg.d_ff:
            self.norm2 = Norm(cfg, device)
            if ffn == "moe":
                self.ffn = moe_mod.MoE(cfg, device)
                if cfg.dense_residual:
                    self.mlp_res = MLP(cfg, device)
                if cfg.shared_expert:
                    self.mlp_shared = MLP(cfg, device)
            else:
                self.ffn = MLP(cfg, device)

    def forward(self, x, cfg: ModelConfig, positions, mode: str,
                cache=None, pos: Optional[int] = None,
                cache_len: Optional[int] = None):
        """Returns (x, new cache or None, the MoE's aux or None)."""
        h = self.norm1(x)
        if self.mixer_kind == "attn":
            if mode == "decode":
                y, new_c = attn_mod.decode_attention(self.mixer, h, cache,
                                                     pos, cfg)
            else:
                y, new_c = attn_mod.self_attention(
                    self.mixer, h, cfg, positions,
                    return_cache=(mode == "prefill"), cache_len=cache_len)
        elif mode == "decode":
            y, new_c = mamba_mod.decode_mamba(self.mixer, h, cache, cfg)
        else:
            y, new_c = mamba_mod.apply_mamba(
                self.mixer, h, cfg, return_cache=(mode == "prefill"))
        x = x + y
        aux = None
        if cfg.d_ff:
            h2 = self.norm2(x)
            if self.ffn_kind == "moe":
                y2, aux = moe_mod.apply_moe(
                    self.ffn, h2, cfg, mlp_res=getattr(self, "mlp_res", None),
                    mlp_shared=getattr(self, "mlp_shared", None))
            else:
                y2 = self.ffn(h2)
            x = x + y2
        return x, new_c, aux


class Transformer(nn.Module):
    """``embed`` (tok, head, pos), ``layers`` (one ``Block`` a layer) and
    ``norm_f``: the reference's parameter tree with the group stack laid
    out as layers (``convert.lm_params_to_port``).  Built with
    uninitialised weights; ``init_model`` draws them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        cfg.validate()
        check_supported(cfg)
        period(cfg)
        self.cfg = cfg
        self.embed = Embedding(cfg, device)
        self.layers = nn.ModuleList(
            Block(cfg, mixer, ffn, device)
            for mixer, ffn in zip(cfg.layer_kinds(), cfg.ffn_kinds()))
        self.norm_f = Norm(cfg, device)


def init_model(cfg: ModelConfig, seed: int = 0,
               device: DeviceLike = None) -> Transformer:
    """A model with random weights drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (default ``cuda``; raises without a card
    unless ``device="cpu"``).  The reference draws from ``jax.random``, so
    the two packages' weights differ for one seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = Transformer(cfg, dev)
    with torch.no_grad():
        model.embed.reset_parameters(gen)
        for layer in model.layers:
            for name in ("mixer", "ffn", "mlp_res", "mlp_shared"):
                part = getattr(layer, name, None)
                if part is not None:
                    part.reset_parameters(gen)
    return model.eval()


def _embed_input(params: Transformer, batch, cfg: ModelConfig):
    """Token embedding; returns (x, positions, n_prefix)."""
    tokens = batch["tokens"]
    x = params.embed.embed(tokens)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions, 0


def _run_stack(params: Transformer, x, cfg: ModelConfig, positions,
               mode: str, caches=None, pos: Optional[int] = None,
               cache_len: Optional[int] = None):
    """Returns (x, the MoE layers' summed aux (fp32 scalar), the new
    caches, one a layer, or None in ``train`` mode)."""
    new_caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer in enumerate(params.layers):
        x, c, aux = layer(x, cfg, positions, mode,
                          cache=caches[i] if caches is not None else None,
                          pos=pos, cache_len=cache_len)
        new_caches.append(c)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total, (new_caches if mode != "train" else None)


@torch.no_grad()
def forward(params: Transformer, batch, cfg: ModelConfig,
            mode: str = "train"):
    """Full-sequence forward. Returns (logits, aux, caches, enc_kvs,
    n_prefix) as the reference does; ``aux`` is the MoE layers' summed
    load-balance loss, ``caches`` one ``KVCache`` or ``MambaCache`` a
    layer in ``prefill`` mode, else None."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward mode {mode!r}; expected train or prefill")
    x, positions, n_prefix = _embed_input(params, batch, cfg)
    x, aux, caches = _run_stack(params, x, cfg, positions, mode)
    x = params.norm_f(x)
    logits = params.embed.unembed(x)
    return logits, aux, caches, None, n_prefix


class DecodeState(NamedTuple):
    # one cache a layer: a head-major KVCache (attention) or a MambaCache
    caches: List[Union[attn_mod.KVCache, mamba_mod.MambaCache]]
    enc_kvs: Any                    # cross-attn KV (encdec): None here
    pos: int                        # next position to write (host int)


@torch.no_grad()
def prefill(params: Transformer, batch, cfg: ModelConfig,
            cache_len: Optional[int] = None):
    """Run the prompt, build the decode state.  Returns (last_logits
    (B, padded_vocab), state).

    ``cache_len``: total KV capacity (>= prompt length) of the attention
    layers' caches; extra slots are zero-filled and never attended before
    a decode step writes them.  A ``MambaCache`` has no length.
    """
    x, positions, n_prefix = _embed_input(params, batch, cfg)
    x, _, caches = _run_stack(params, x, cfg, positions, "prefill",
                              cache_len=cache_len)
    x = params.norm_f(x[:, -1])
    logits = params.embed.unembed(x)
    prompt_len = batch["tokens"].shape[1] + n_prefix
    return logits, DecodeState(caches=caches, enc_kvs=None, pos=prompt_len)


@torch.no_grad()
def decode_step(params: Transformer, state: DecodeState, token,
                cfg: ModelConfig):
    """token: (B,) integer -> (logits (B, padded_vocab), new state).  The
    state's KV caches are updated in place and carried into the new one;
    each ``MambaCache`` is replaced."""
    x = params.embed.embed(token[:, None])
    x, _, caches = _run_stack(params, x, cfg, None, "decode",
                              caches=state.caches, pos=state.pos)
    x = params.norm_f(x)
    logits = params.embed.unembed(x)[:, 0, :]
    return logits, DecodeState(caches=caches, enc_kvs=state.enc_kvs,
                               pos=state.pos + 1)


def make_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=None, device: DeviceLike = None) -> DecodeState:
    """Zero-initialised decode state with KV capacity ``cache_len`` (and,
    as in the reference, ``pos = cache_len``): a ``KVCache`` for each
    attention layer, a ``MambaCache`` for each mamba layer."""
    check_supported(cfg)
    dtype = dtype or cfg.torch_dtype()
    dev = resolve_device(device)
    caches = [attn_mod.init_cache(cfg, batch, cache_len, dtype, dev)
              if kind == "attn" else
              mamba_mod.init_mamba_cache(cfg, batch, dtype, dev)
              for kind in cfg.layer_kinds()]
    return DecodeState(caches=caches, enc_kvs=None, pos=cache_len)


__all__ = ["DecodeState", "Transformer", "check_supported", "decode_step",
           "forward", "init_model", "make_decode_state", "period", "prefill"]
