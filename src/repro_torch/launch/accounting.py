"""Analytical parameter / FLOP accounting per architecture and shape cell
(a copy of ``repro.launch.accounting``: plain Python over the config).

MODEL_FLOPS follows the grading convention: 6*N*D for training (N = active
params, D = tokens processed) and 2*N*D for inference lowerings.
"""
from __future__ import annotations

from typing import Dict

from ..configs.shapes import ShapeCell
from ..models.config import ModelConfig


def _attn_params(cfg: ModelConfig, true_heads: bool = True) -> int:
    H = cfg.n_heads if true_heads else cfg.padded_heads
    d, hd, KV = cfg.d_model, cfg.head_dim, cfg.n_kv_heads
    p = d * H * hd * 2              # wq + wo
    p += d * KV * hd * 2            # wk + wv
    if cfg.qkv_bias:
        p += (H + 2 * KV) * hd
    return p


def _mamba_params(cfg: ModelConfig) -> int:
    d, di, N, R = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    return (d * 2 * di + cfg.d_conv * di + di + di * (R + 2 * N)
            + R * di + di + di * N + di + di * d)


def _mlp_params(cfg: ModelConfig) -> int:
    mult = 3 if cfg.mlp == "swiglu" else 2
    return mult * cfg.d_model * cfg.d_ff


def param_counts(cfg: ModelConfig) -> Dict[str, int]:
    """total and active (per-token) parameter counts."""
    total = active = 0
    mixers = cfg.layer_kinds()
    ffns = cfg.ffn_kinds()
    for mix, ffn in zip(mixers, ffns):
        p_mix = _attn_params(cfg) if mix == "attn" else _mamba_params(cfg)
        total += p_mix
        active += p_mix
        if cfg.d_ff:
            if ffn == "moe":
                expert = _mlp_params(cfg)
                total += cfg.n_experts * expert + cfg.d_model * cfg.n_experts
                active += cfg.top_k * expert
                if cfg.dense_residual:
                    total += _mlp_params(cfg)
                    active += _mlp_params(cfg)
                if cfg.shared_expert:
                    total += _mlp_params(cfg)
                    active += _mlp_params(cfg)
            else:
                total += _mlp_params(cfg)
                active += _mlp_params(cfg)
    if cfg.family == "encdec":
        enc = cfg.encoder_layers * (_attn_params(cfg) + 2 * cfg.d_model
                                    * cfg.d_ff)
        cross = cfg.n_layers * _attn_params(cfg)
        total += enc + cross
        active += enc + cross
    emb = cfg.vocab_size * cfg.d_model
    head = 0 if cfg.tie_embeddings else emb
    total += emb + head
    active += emb + head
    return {"total": total, "active": active}


def model_flops(cfg: ModelConfig, shape: ShapeCell) -> float:
    n_active = param_counts(cfg)["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
