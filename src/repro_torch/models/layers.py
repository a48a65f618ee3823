"""Shared layer primitives: norms, RoPE, MLPs, embeddings (port of
``repro.models.layers``).

Each parameterised piece is an ``nn.Module`` whose tensors have the
reference's names and shapes, so ``convert.lm_params_to_port`` maps the
reference's tree onto ``state_dict`` keys one to one: ``Norm`` is
``init_norm``/``apply_norm`` (``scale``, ``bias``), ``MLP`` is
``init_mlp``/``apply_mlp`` (``wi``, ``wg``, ``wo``) and ``Embedding`` is
``init_embedding``/``embed_tokens``/``unembed`` (``tok``, ``head`` and,
with ``pos_embed == "learned"``, the 4096-row position table ``pos``);
``sinusoidal_embedding`` is the encoder's fixed table.  Computation is
dtype-polymorphic as in the reference: norms and
RoPE compute in fp32 and return the activation dtype; weights are stored
in the config's dtype, norm parameters in fp32.  ``reset_parameters``
draws from an explicit ``torch.Generator``; the reference's JAX draws
differ, so parity carries the reference's values across instead of
re-drawing them.

On a mesh (``rules`` of a bound ``Mesh``; ``REPLICATED`` by default, where
every collective is the identity) each module holds its local shard, its
``roles()`` naming each tensor's per-dim roles (the reference's ``Px``
annotations): ``MLP`` is column-parallel in ``wi``/``wg`` and
row-parallel in ``wo``, its partial output all-reduced over "model";
``Embedding`` is vocab-parallel (``tok`` ("vocab", "fsdp"): the lookup
masked to this rank's rows, then all-reduced; ``unembed`` gives this
rank's vocab columns, the padding masked by global index, so only in the
last shard); ``Norm`` is replicated.  Every ``"fsdp"`` dim is gathered
before use (``collectives.fsdp_gather``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..parallel import collectives as C
from ..parallel.sharding import REPLICATED
from .config import ModelConfig

NEG_INF = -1e30  # the reference's mask value (scores and padded vocab)


def _normal(gen: Optional[torch.Generator], w: torch.Tensor,
            scale: float) -> None:
    """Fill ``w`` in place with ``scale`` x a standard normal draw in fp32,
    cast to ``w``'s dtype (the reference's ``_normal``).  The draw is the
    one transient: scaled in place and copied into ``w``, which casts it,
    so its values are those of ``(scale * x).to(dtype)``."""
    x = torch.randn(w.shape, generator=gen, dtype=torch.float32,
                    device=w.device)
    w.copy_(x.mul_(scale))


def _param(t: torch.Tensor) -> nn.Parameter:
    """A parameter without gradients: serving's default.  A model built
    for training turns them on (``Transformer(..., train=True)``)."""
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """rmsnorm (``scale``), layernorm (``scale``, ``bias``) or olmo's
    nonparametric layernorm (no parameters)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.kind = cfg.norm
        if cfg.norm != "nonparametric":
            self.scale = _param(torch.ones(cfg.d_model, dtype=torch.float32,
                                           device=device))
        if cfg.norm == "layernorm":
            self.bias = _param(torch.zeros(cfg.d_model, dtype=torch.float32,
                                           device=device))

    def roles(self) -> dict:
        return {"scale": (None,), "bias": (None,)}

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        xf = x.float()
        if self.kind == "rmsnorm":
            xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
            return (xf * self.scale).to(x.dtype)
        mean = torch.mean(xf, -1, keepdim=True)
        var = torch.mean(torch.square(xf - mean), -1, keepdim=True)
        xf = (xf - mean) * torch.rsqrt(var + eps)
        if self.kind == "layernorm":
            xf = xf * self.scale + self.bias
        return xf.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split RoPE in fp32.  x: (B, S, H, D), positions: (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs        # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def sinusoidal_embedding(n_pos: int, d: int, device=None) -> torch.Tensor:
    """(n_pos, d) fp32: [sin | cos] of pos / 10000^(2i / d)."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


# ---------------------------------------------------------------------------
# dense / MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """swiglu (``wi``, ``wg``, ``wo``) or gelu (``wi``, ``wo``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d_ff = cfg.d_ff
        dt = cfg.torch_dtype()
        self.kind = cfg.mlp
        self.wi = _param(torch.empty(cfg.d_model, d_ff, dtype=dt,
                                     device=device))
        self.wo = _param(torch.empty(d_ff, cfg.d_model, dtype=dt,
                                     device=device))
        if cfg.mlp == "swiglu":
            self.wg = _param(torch.empty(cfg.d_model, d_ff, dtype=dt,
                                         device=device))

    def reset_parameters(self, gen: Optional[torch.Generator]) -> None:
        d_model, d_ff = self.wi.shape
        scale_in = 1.0 / math.sqrt(d_model)
        # the reference's key order: wi, wg, wo
        _normal(gen, self.wi, scale_in)
        if self.kind == "swiglu":
            _normal(gen, self.wg, scale_in)
        _normal(gen, self.wo, 1.0 / math.sqrt(d_ff))

    def roles(self) -> dict:
        return {"wi": ("fsdp", "tp"), "wg": ("fsdp", "tp"),
                "wo": ("tp", "fsdp")}

    def partial(self, x: torch.Tensor, rules=REPLICATED) -> torch.Tensor:
        """This rank's share of the output (the reference's
        ``_dense_partial``): x already in the "model" region."""
        h = x @ C.fsdp_gather(self.wi, rules, 0)
        if self.kind == "swiglu":
            h = nn.functional.silu(x @ C.fsdp_gather(self.wg, rules, 0)) * h
        else:
            h = nn.functional.gelu(h, approximate="tanh")  # jax.nn.gelu
        return h @ C.fsdp_gather(self.wo, rules, 1)

    def forward(self, x: torch.Tensor, rules=REPLICATED) -> torch.Tensor:
        return C.reduce_from(self.partial(C.copy_to(x, rules), rules), rules)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

POS_ROWS = 4096  # the learned position table's rows; indexed mod POS_ROWS


class Embedding(nn.Module):
    """``tok`` (padded_vocab, d); ``head`` (d, padded_vocab) unless the
    embeddings are tied; ``pos`` (4096, d) with learned positions."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = cfg.torch_dtype()
        self.cfg = cfg
        self.tok = _param(torch.empty(cfg.padded_vocab, cfg.d_model,
                                      dtype=dt, device=device))
        if not cfg.tie_embeddings:
            self.head = _param(torch.empty(cfg.d_model, cfg.padded_vocab,
                                           dtype=dt, device=device))
        if cfg.pos_embed == "learned":
            self.pos = _param(torch.empty(POS_ROWS, cfg.d_model, dtype=dt,
                                          device=device))

    def reset_parameters(self, gen: Optional[torch.Generator]) -> None:
        cfg = self.cfg
        _normal(gen, self.tok, 0.02)
        if not cfg.tie_embeddings:
            _normal(gen, self.head, 1.0 / math.sqrt(cfg.d_model))
        if cfg.pos_embed == "learned":
            _normal(gen, self.pos, 0.02)

    def roles(self) -> dict:
        return {"tok": ("vocab", "fsdp"), "head": ("fsdp", "vocab"),
                "pos": (None, "fsdp")}

    def vocab_offset(self, rules=REPLICATED) -> int:
        """The global id of this rank's first vocab row."""
        return rules.index("vocab") * self.tok.shape[0]

    def embed(self, tokens: torch.Tensor, rules=REPLICATED) -> torch.Tensor:
        tok = C.fsdp_gather(self.tok, rules, 1)
        if rules.size("vocab") == 1:
            return tok[tokens]
        rel = tokens - self.vocab_offset(rules)
        mine = (rel >= 0) & (rel < tok.shape[0])
        x = tok[rel.clamp(0, tok.shape[0] - 1)]
        x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
        return C.reduce_from(x, rules, "vocab")

    def position(self, positions, rules=REPLICATED) -> torch.Tensor:
        """The learned rows at ``positions`` (a tensor or an int) mod 4096."""
        pos = C.fsdp_gather(self.pos, rules, 1)
        return pos[positions % pos.shape[0]]

    def unembed(self, x: torch.Tensor, rules=REPLICATED) -> torch.Tensor:
        """Logits (..., padded_vocab), the padded entries at -1e30; on a
        mesh this rank's vocab columns (..., padded_vocab / shards)."""
        cfg = self.cfg
        w = (C.fsdp_gather(self.tok, rules, 1).mT if cfg.tie_embeddings
             else C.fsdp_gather(self.head, rules, 0))
        logits = C.copy_to(x, rules, "vocab") @ w
        v0 = self.vocab_offset(rules)
        if v0 + w.shape[1] > cfg.vocab_size:
            logits[..., max(0, cfg.vocab_size - v0):] = NEG_INF
        return logits
