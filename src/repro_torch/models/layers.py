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
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .config import ModelConfig

NEG_INF = -1e30  # the reference's mask value (scores and padded vocab)


def _normal(gen: Optional[torch.Generator], shape, dtype, scale: float,
            device) -> torch.Tensor:
    """``scale`` x a standard normal draw in fp32, cast to ``dtype`` (the
    reference's ``_normal``)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (scale * x).to(dtype)


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
        dev = self.wi.device
        # the reference's key order: wi, wg, wo
        self.wi.copy_(_normal(gen, self.wi.shape, self.wi.dtype, scale_in,
                              dev))
        if self.kind == "swiglu":
            self.wg.copy_(_normal(gen, self.wg.shape, self.wg.dtype,
                                  scale_in, dev))
        self.wo.copy_(_normal(gen, self.wo.shape, self.wo.dtype,
                              1.0 / math.sqrt(d_ff), dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x @ self.wi
        if self.kind == "swiglu":
            h = nn.functional.silu(x @ self.wg) * h
        else:
            h = nn.functional.gelu(h, approximate="tanh")  # jax.nn.gelu
        return h @ self.wo


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
        cfg, dev = self.cfg, self.tok.device
        self.tok.copy_(_normal(gen, self.tok.shape, self.tok.dtype, 0.02,
                               dev))
        if not cfg.tie_embeddings:
            self.head.copy_(_normal(gen, self.head.shape, self.head.dtype,
                                    1.0 / math.sqrt(cfg.d_model), dev))
        if cfg.pos_embed == "learned":
            self.pos.copy_(_normal(gen, self.pos.shape, self.pos.dtype, 0.02,
                                   dev))

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.tok[tokens]

    def position(self, positions) -> torch.Tensor:
        """The learned rows at ``positions`` (a tensor or an int) mod 4096."""
        return self.pos[positions % self.pos.shape[0]]

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Logits (..., padded_vocab), the padded entries at -1e30."""
        cfg = self.cfg
        w = self.tok.mT if cfg.tie_embeddings else self.head
        logits = x @ w
        if cfg.padded_vocab > cfg.vocab_size:
            logits[..., cfg.vocab_size:] = NEG_INF
        return logits
