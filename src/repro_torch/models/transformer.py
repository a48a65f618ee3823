"""The transformer stack (port of ``repro.models.transformer``) for every
family: dense, moe, ssm, hybrid, encdec (whisper) and vlm (llava's
backbone): ``init_model``, ``forward`` (modes ``prefill`` and ``train``),
``loss_fn``, ``prefill``, ``decode_step``, ``DecodeState``,
``make_decode_state`` and ``encoder_view``.

A layer's mixer is attention or ``Mamba`` and its FFN an ``MLP`` or a
``MoE`` (with arctic's dense residual ``mlp_res`` or llama4's shared
expert ``mlp_shared``), by ``cfg.layer_kinds()`` and ``cfg.ffn_kinds()``;
``d_ff == 0`` (falcon-mamba) means no FFN.  The reference stacks each
period of layers (``period``) into groups and scans over them; here the
layers are an ``nn.ModuleList`` run in order, and the decode state holds
one cache a layer: a head-major ``KVCache`` (``attention``'s module
docstring) or a ``MambaCache``.  ``scan_layers`` stays a config field
with no effect.

On a mesh every function takes ``rules`` (``REPLICATED`` by default, the
one-device path) and the model holds this rank's shard of each parameter
(``shard_model``, or ``init_model(..., rules=)``: every rank draws the
whole model from the seed and keeps its shard).  ``param_axes(model)``
gives each parameter's roles (the reference's, parameter by parameter)
and ``param_shardings`` their ``Sharding``s; ``decode_state_axes`` the
decode state's.  The batch is this rank's rows.  ``forward`` returns this
rank's vocab columns of the logits; ``prefill`` and ``decode_step``
gather them whole.  ``loss_fn`` is a vocab-parallel cross-entropy (an
all-reduce of the max, then of the sum, the gold logit from the rank
that holds it) over the global batch: its first value is this rank's
objective (its rows' share of the cross-entropy plus the aux term),
whose gradients summed over the batch ranks are the global loss's; the
metrics hold the global ``ce`` and ``aux``.

Training.  ``Transformer(cfg, train=True)`` (``init_model(...,
train=True)``) gives parameters that require gradients; serving's models
have none.  ``forward(..., mode="train")`` builds the autograd graph
wherever gradients are enabled, with each decoder and encoder layer
under ``torch.utils.checkpoint`` when ``cfg.remat`` is set (the
reference's ``jax.checkpoint`` of each group; here of each layer): a
layer's activations are recomputed in the backward pass, and with them
its flash and scan calls.  ``loss_fn`` is the reference's: the fp32
cross-entropy of the shifted logits past ``n_prefix`` plus ``AUX_COEF``
x the MoE layers' ``aux``.

encdec: ``Transformer.encoder`` runs the stub frontend's frames (B, F,
d) plus the sinusoidal table through ``encoder_view(cfg)``'s blocks with
non-causal attention and its own ``norm_f``; each decoder ``Block`` adds
``norm_x`` and ``cross`` (self attention, then cross attention, then the
FFN) and projects the encoder output once into its cross K/V, which
prefill keeps in ``DecodeState.enc_kvs`` (one head-major ``KVCache`` a
decoder layer) and every decode step attends unchanged.  Learned
positions (``embed.pos``, 4096 rows) are added at ``position % 4096``.
vlm: ``batch["patches"]`` (B, P, d), the stub vision tower's output, is
prepended to the token embeddings; positions run over patches and text
and ``n_prefix`` = P.

Prefill returns the last position's logits and, to keep memory at the
size of one row, unembeds only that position: (B, d) @ (d, vocab) gives
the same values as the reference's full (B, S, vocab) logits sliced at
-1 (at olmo-1b's B 4 x S 4096 x 50304 those would be 1.65 GB in bf16).
``forward`` keeps the reference's full logits and returns the MoE layers'
summed load-balance ``aux``.

``prefill`` and ``decode_step`` run under ``torch.no_grad()``, as does
``forward`` in ``prefill`` mode; ``decode_step`` writes the new
token's K and V into the state's KV caches in place (JAX's
``donate_argnums`` in the reference's serve loop) and replaces each
``MambaCache``, so a state is consumed by the step that takes it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, NamedTuple, Optional, Union

import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..backends import registry
from ..parallel import collectives as C
from ..parallel.sharding import REPLICATED, Sharding, pad_to_multiple
from . import attention as attn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from .config import ModelConfig
from .layers import Embedding, MLP, Norm, sinusoidal_embedding

AUX_COEF = 0.01  # MoE load-balance loss weight


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config no model can be built from: an ``ssm_dtype``
    other than float32 and bfloat16 in a model with Mamba layers (a
    ``KeyError``, as the reference's ``apply_mamba`` raises)."""
    if "mamba" in cfg.layer_kinds():
        cfg.ssm_torch_dtype()


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


def encoder_view(cfg: ModelConfig) -> ModelConfig:
    """Encoder layers: same widths, non-causal attention, single-layer
    period, no MoE."""
    return dataclasses.replace(cfg, family="dense",
                               n_layers=cfg.encoder_layers, n_experts=0,
                               attn_every=0)


class Block(nn.Module):
    """norm1 -> mixer (attention or ``Mamba``) -> residual; in a decoder
    (``decoder``) norm_x -> cross attention -> residual; norm2 -> FFN
    (``MLP``, or ``MoE`` with ``mlp_res`` / ``mlp_shared``) -> residual."""

    def __init__(self, cfg: ModelConfig, mixer: str, ffn: str, device=None,
                 decoder: bool = False):
        super().__init__()
        self.mixer_kind, self.ffn_kind = mixer, ffn
        self.norm1 = Norm(cfg, device)
        self.mixer = (attn_mod.Attention(cfg, device) if mixer == "attn"
                      else mamba_mod.Mamba(cfg, device))
        if decoder:
            self.norm_x = Norm(cfg, device)
            self.cross = attn_mod.Attention(cfg, device)
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
                cache_len: Optional[int] = None, enc_out=None, enc_kv=None,
                causal: bool = True, rules=REPLICATED):
        """Returns (x, new cache or None, the cross K/V (a decoder's, in
        ``prefill`` and ``decode``) or None, the MoE's aux or None)."""
        h = self.norm1(x)
        if self.mixer_kind == "attn":
            if mode == "decode":
                y, new_c = attn_mod.decode_attention(self.mixer, h, cache,
                                                     pos, cfg, rules=rules)
            else:
                y, new_c = attn_mod.self_attention(
                    self.mixer, h, cfg, positions, causal=causal,
                    return_cache=(mode == "prefill"), cache_len=cache_len,
                    rules=rules)
        elif mode == "decode":
            y, new_c = mamba_mod.decode_mamba(self.mixer, h, cache, cfg,
                                              rules)
        else:
            y, new_c = mamba_mod.apply_mamba(
                self.mixer, h, cfg, return_cache=(mode == "prefill"),
                rules=rules)
        x = x + y
        new_enc_kv = None
        if hasattr(self, "cross"):
            hx = self.norm_x(x)
            if mode == "decode":
                yx, new_enc_kv = attn_mod.decode_attention(
                    self.cross, hx, enc_kv, pos, cfg, cross=True,
                    rules=rules)
            else:
                ekv = attn_mod.cross_kv(self.cross, enc_out, rules)
                yx = attn_mod.cross_attention(self.cross, hx, ekv, cfg,
                                              rules)
                new_enc_kv = ekv if mode == "prefill" else None
            x = x + yx
        aux = None
        if cfg.d_ff:
            h2 = self.norm2(x)
            if self.ffn_kind == "moe":
                y2, aux = moe_mod.apply_moe(
                    self.ffn, h2, cfg, mlp_res=getattr(self, "mlp_res", None),
                    mlp_shared=getattr(self, "mlp_shared", None), rules=rules)
            else:
                y2 = self.ffn(h2, rules)
            x = x + y2
        return x, new_c, new_enc_kv, aux


class Encoder(nn.Module):
    """The encoder-decoder's encoder: ``layers`` (``encoder_layers``
    blocks of ``encoder_view(cfg)``) and its own ``norm_f``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        enc_cfg = encoder_view(cfg)
        self.layers = nn.ModuleList(Block(enc_cfg, "attn", "mlp", device)
                                    for _ in range(cfg.encoder_layers))
        self.norm_f = Norm(enc_cfg, device)


class Transformer(nn.Module):
    """``embed`` (tok, head, pos), ``layers`` (one ``Block`` a layer),
    ``norm_f`` and, for encdec, ``encoder``: the reference's parameter
    tree with the group stack laid out as layers
    (``convert.lm_params_to_port``).  Built with uninitialised weights;
    ``init_model`` draws them.  Its parameters require gradients with
    ``train``, and not otherwise."""

    def __init__(self, cfg: ModelConfig, device=None, train: bool = False):
        super().__init__()
        cfg.validate()
        check_supported(cfg)
        period(cfg)
        self.cfg = cfg
        decoder = cfg.family == "encdec"
        self.embed = Embedding(cfg, device)
        self.layers = nn.ModuleList(
            Block(cfg, mixer, ffn, device, decoder=decoder)
            for mixer, ffn in zip(cfg.layer_kinds(), cfg.ffn_kinds()))
        self.norm_f = Norm(cfg, device)
        if decoder:
            self.encoder = Encoder(cfg, device)
        self.requires_grad_(train)


def init_model(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
               train: bool = False, rules=None) -> Transformer:
    """A model with random weights drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (default ``cuda``; raises without a card
    unless ``device="cpu"``), its parameters requiring gradients with
    ``train``.  The reference draws from ``jax.random``, so the two
    packages' weights differ for one seed.  With ``rules`` of a mesh the
    whole model is drawn and each parameter cut to this rank's shard
    (``shard_model``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = Transformer(cfg, dev, train=train)
    layers = list(model.layers)
    if cfg.family == "encdec":
        layers += list(model.encoder.layers)
    with torch.no_grad():
        model.embed.reset_parameters(gen)
        for layer in layers:
            for name in ("mixer", "cross", "ffn", "mlp_res", "mlp_shared"):
                part = getattr(layer, name, None)
                if part is not None:
                    part.reset_parameters(gen)
    if rules is not None:
        shard_model(model, rules)
    return model.train(train)


def param_axes(model: Transformer) -> dict:
    """Each parameter's roles a dim, keyed by its name (the reference's
    ``Px`` annotations, parameter by parameter; a layer's leaf carries no
    ``"layers"`` role, the port's layers being a list)."""
    out = {}
    for prefix, mod in model.named_modules():
        if not hasattr(mod, "roles"):
            continue
        roles = mod.roles()
        for name, _ in mod.named_parameters(recurse=False):
            out[f"{prefix}.{name}" if prefix else name] = roles[name]
    return out


def param_chunks(model: Transformer) -> dict:
    """{name: {dim: pieces}} of the parameters stored in pieces (mamba's
    ``in_proj``)."""
    out = {}
    for prefix, mod in model.named_modules():
        for name, ch in getattr(mod, "CHUNKS", {}).items():
            out[f"{prefix}.{name}"] = ch
    return out


def param_shardings(model: Transformer, rules) -> dict:
    """A ``Sharding`` for each parameter under ``rules``."""
    chunks = param_chunks(model)
    return {k: Sharding(rules, ax, chunks.get(k))
            for k, ax in param_axes(model).items()}


def shard_model(model: Transformer, rules) -> Transformer:
    """Cut each parameter of a whole model to this rank's shard, in
    place."""
    sh = param_shardings(model, rules)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if sh[name].is_sharded():
                p.data = sh[name].local(p.data).contiguous().clone()
    return model


def _embed_input(params: Transformer, batch, cfg: ModelConfig,
                 rules=REPLICATED):
    """Token (+ the vlm's patch prefix) embedding, plus learned
    positions; returns (x, positions, n_prefix)."""
    x = params.embed.embed(batch["tokens"], rules)
    n_prefix = 0
    if cfg.family == "vlm" and "patches" in batch:
        patches = batch["patches"].to(x.dtype)
        x = torch.cat([patches, x], dim=1)
        n_prefix = patches.shape[1]
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    if cfg.pos_embed == "learned":
        x = x + params.embed.position(positions[0], rules)
    return x, positions, n_prefix


def _encode(params: Transformer, batch, cfg: ModelConfig,
            rules=REPLICATED) -> torch.Tensor:
    """The stub frontend's frames (B, F, d), in the model's dtype, plus
    the sinusoidal table through the encoder (non-causal) -> (B, F, d)."""
    frames = batch["frames"].to(cfg.torch_dtype())
    b, f, _ = frames.shape
    x = frames + sinusoidal_embedding(f, cfg.d_model,
                                      frames.device).to(frames.dtype)
    positions = torch.arange(f, device=x.device).expand(b, f)
    enc_cfg = encoder_view(cfg)
    for layer in params.encoder.layers:
        x = _layer_call(layer, cfg.remat)(x, enc_cfg, positions, "train",
                                          causal=False, rules=rules)[0]
    return params.encoder.norm_f(x)


def _layer_call(layer: Block, remat: bool):
    """``layer`` itself, or, with ``remat`` where gradients are enabled,
    ``layer`` under ``torch.utils.checkpoint``: its activations are not
    kept but recomputed in the backward pass.  The recompute runs on
    autograd's thread, which for a CUDA tensor is not the caller's: it
    re-enters the caller's scoped backend (``registry.use_backend``), so
    that it runs the ops the forward ran."""
    if not (remat and torch.is_grad_enabled()):
        return layer
    scoped = registry.scoped_backend()

    def contexts():
        return contextlib.nullcontext(), (
            registry.use_backend(scoped) if scoped
            else contextlib.nullcontext())

    return lambda *args, **kw: checkpoint(layer, *args, use_reentrant=False,
                                          context_fn=contexts, **kw)


def _run_stack(params: Transformer, x, cfg: ModelConfig, positions,
               mode: str, caches=None, pos: Optional[int] = None,
               cache_len: Optional[int] = None, enc_out=None, enc_kvs=None,
               rules=REPLICATED):
    """Returns (x, the MoE layers' summed aux (fp32 scalar), the new
    caches, one a layer, or None in ``train`` mode, and the decoder's
    cross K/V, one a layer, or None)."""
    new_caches, new_enc_kvs = [], []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and mode == "train"
    for i, layer in enumerate(params.layers):
        x, c, ekv, aux = _layer_call(layer, remat)(
            x, cfg, positions, mode,
            cache=caches[i] if caches is not None else None, pos=pos,
            cache_len=cache_len, enc_out=enc_out,
            enc_kv=enc_kvs[i] if enc_kvs is not None else None, rules=rules)
        new_caches.append(c)
        new_enc_kvs.append(ekv)
        if aux is not None:
            aux_total = aux_total + aux
    enc = new_enc_kvs if cfg.family == "encdec" and mode != "train" else None
    return x, aux_total, (new_caches if mode != "train" else None), enc


def _decoder_input(params: Transformer, batch, cfg: ModelConfig,
                   rules=REPLICATED):
    """(x, positions, n_prefix, the encoder output or None)."""
    enc_out = (_encode(params, batch, cfg, rules) if cfg.family == "encdec"
               else None)
    return (*_embed_input(params, batch, cfg, rules), enc_out)


def forward(params: Transformer, batch, cfg: ModelConfig,
            mode: str = "train", rules=REPLICATED):
    """Full-sequence forward. Returns (logits, aux, caches, enc_kvs,
    n_prefix) as the reference does; ``aux`` is the MoE layers' summed
    load-balance loss, ``caches`` one ``KVCache`` or ``MambaCache`` a
    layer in ``prefill`` mode, else None, ``enc_kvs`` the decoder's cross
    K/V (encdec, ``prefill`` mode), else None.  ``train`` mode builds the
    autograd graph where gradients are enabled; ``prefill`` never does."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward mode {mode!r}; expected train or prefill")
    with torch.set_grad_enabled(torch.is_grad_enabled() and mode == "train"):
        x, positions, n_prefix, enc_out = _decoder_input(params, batch, cfg,
                                                         rules)
        x, aux, caches, enc_kvs = _run_stack(params, x, cfg, positions,
                                             mode, enc_out=enc_out,
                                             rules=rules)
        x = params.norm_f(x)
        logits = params.embed.unembed(x, rules)
    return logits, aux, caches, enc_kvs, n_prefix


def loss_fn(params: Transformer, batch, cfg: ModelConfig, rules=REPLICATED):
    """The training loss: (ce + ``AUX_COEF`` x aux, {"ce", "aux"}), ce the
    fp32 cross-entropy of the logits past ``n_prefix`` (the vlm's patches)
    at each position against the next token.  On a mesh the first value
    is this rank's objective (module docstring) and ``ce`` the global
    batch's."""
    logits, aux, _, _, n_prefix = forward(params, batch, cfg, "train",
                                          rules)
    tokens = batch["tokens"]
    preds = logits[:, n_prefix:][:, :-1].float()
    targets = tokens[:, 1:].long()
    nb = rules.size("batch")
    if rules.size("vocab") == 1:
        logz = torch.logsumexp(preds, dim=-1)
        gold = torch.gather(preds, -1, targets[..., None])[..., 0]
        if nb == 1:
            ce = (logz - gold).mean()
            return ce + AUX_COEF * aux, {"ce": ce, "aux": aux}
    else:   # vocab-parallel: the max, the sum and the gold logit reduced
        m = C.role_all_reduce(preds.detach().amax(-1), rules, "vocab", "max")
        logz = m + torch.log(C.reduce_from(
            torch.exp(preds - m[..., None]).sum(-1), rules, "vocab"))
        rel = targets - params.embed.vocab_offset(rules)
        mine = (rel >= 0) & (rel < preds.shape[-1])
        gold = torch.gather(preds, -1, rel.clamp(0, preds.shape[-1] - 1)
                            [..., None])[..., 0]
        gold = C.reduce_from(torch.where(mine, gold, torch.zeros_like(gold)),
                             rules, "vocab")
    share = (logz - gold).sum() / (logz.numel() * nb)
    ce = C.role_all_reduce(share.detach(), rules, "batch")
    return share + AUX_COEF * aux, {"ce": ce, "aux": aux.detach()}


class DecodeState(NamedTuple):
    # one cache a layer: a head-major KVCache (attention) or a MambaCache
    caches: List[Union[attn_mod.KVCache, mamba_mod.MambaCache]]
    # encdec: the cross K/V, one head-major KVCache a decoder layer
    enc_kvs: Optional[List[attn_mod.KVCache]]
    pos: int                        # next position to write (host int)


@torch.no_grad()
def prefill(params: Transformer, batch, cfg: ModelConfig,
            cache_len: Optional[int] = None, rules=REPLICATED):
    """Run the prompt (with the encdec's ``frames`` or the vlm's
    ``patches``), build the decode state.  Returns (last_logits (B,
    padded_vocab), state).

    ``cache_len``: total KV capacity (>= prompt length, the patch prefix
    included) of the attention layers' caches; extra slots are
    zero-filled and never attended before a decode step writes them.  A
    ``MambaCache`` has no length.  On a mesh the logits are this rank's
    rows with every vocab column, and each cache this rank's block.
    """
    x, positions, n_prefix, enc_out = _decoder_input(params, batch, cfg,
                                                     rules)
    x, _, caches, enc_kvs = _run_stack(params, x, cfg, positions, "prefill",
                                       cache_len=cache_len, enc_out=enc_out,
                                       rules=rules)
    x = params.norm_f(x[:, -1])
    logits = C.role_all_gather(params.embed.unembed(x, rules), rules,
                               "vocab", -1)
    prompt_len = batch["tokens"].shape[1] + n_prefix
    return logits, DecodeState(caches=caches, enc_kvs=enc_kvs,
                               pos=prompt_len)


@torch.no_grad()
def decode_step(params: Transformer, state: DecodeState, token,
                cfg: ModelConfig, rules=REPLICATED):
    """token: (B,) integer -> (logits (B, padded_vocab), new state).  The
    state's KV caches are updated in place and carried into the new one;
    each ``MambaCache`` is replaced; the cross K/V are carried unchanged."""
    x = params.embed.embed(token[:, None], rules)
    if cfg.pos_embed == "learned":
        x = x + params.embed.position(state.pos, rules)
    x, _, caches, _ = _run_stack(params, x, cfg, None, "decode",
                                 caches=state.caches, pos=state.pos,
                                 enc_kvs=state.enc_kvs, rules=rules)
    x = params.norm_f(x)
    logits = C.role_all_gather(params.embed.unembed(x, rules)[:, 0, :],
                               rules, "vocab", -1)
    return logits, DecodeState(caches=caches, enc_kvs=state.enc_kvs,
                               pos=state.pos + 1)


def make_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=None, device: DeviceLike = None,
                      rules=REPLICATED) -> DecodeState:
    """Zero-initialised decode state with KV capacity ``cache_len`` (and,
    as in the reference, ``pos = cache_len``): a ``KVCache`` for each
    attention layer, a ``MambaCache`` for each mamba layer, and for
    encdec a cross ``KVCache`` of capacity ``n_frames`` a layer.  On a
    mesh ``batch`` is the global batch and each leaf this rank's block
    (the capacity rounded up to a multiple of the "seq_tp" shards)."""
    check_supported(cfg)
    dtype = dtype or cfg.torch_dtype()
    dev = resolve_device(device)
    b = batch // rules.size("batch")
    cap = pad_to_multiple(cache_len, rules.size("seq_tp"))
    caches = [attn_mod.init_cache(cfg, b, cap // rules.size("seq_tp"),
                                  dtype, dev)
              if kind == "attn" else
              mamba_mod.init_mamba_cache(
                  cfg, b, dtype, dev, cfg.d_inner // rules.size("tp"))
              for kind in cfg.layer_kinds()]
    enc_kvs = None
    if cfg.family == "encdec":
        enc_kvs = [attn_mod.init_cache(cfg, b, cfg.n_frames, dtype, dev)
                   for _ in range(cfg.n_layers)]
    return DecodeState(caches=caches, enc_kvs=enc_kvs, pos=cache_len)


def decode_state_axes(cfg: ModelConfig) -> DecodeState:
    """The roles of every leaf of a decode state (head-major caches:
    ("batch", None, "seq_tp", None); the encoder's K/V whole on the
    sequence)."""
    kv = attn_mod.cache_axes()
    caches = [kv if kind == "attn" else mamba_mod.mamba_cache_axes()
              for kind in cfg.layer_kinds()]
    enc_kvs = None
    if cfg.family == "encdec":
        enc = ("batch", None, None, None)
        enc_kvs = [attn_mod.KVCache(enc, enc) for _ in range(cfg.n_layers)]
    return DecodeState(caches=caches, enc_kvs=enc_kvs, pos=())


__all__ = ["AUX_COEF", "DecodeState", "Encoder", "Transformer",
           "check_supported", "decode_state_axes", "decode_step",
           "encoder_view", "forward", "init_model", "loss_fn",
           "make_decode_state", "param_axes", "param_chunks",
           "param_shardings", "period", "prefill", "shard_model"]
