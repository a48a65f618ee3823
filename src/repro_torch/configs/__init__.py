"""Architecture registry: ``--arch <id>`` -> ModelConfig, plus reduced
smoke-test configs (port of ``repro.configs``; the ten architecture files
are copied as data).  ``configs/shapes.py`` holds the shape cells."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from ..models.config import ModelConfig

from . import (arctic_480b, falcon_mamba_7b, granite_34b, granite_8b,
               jamba_v0_1_52b, llama4_maverick_400b_a17b, llava_next_34b,
               olmo_1b, qwen1_5_32b, whisper_small)

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (
        jamba_v0_1_52b, arctic_480b, llama4_maverick_400b_a17b,
        falcon_mamba_7b, whisper_small, granite_8b, granite_34b, olmo_1b,
        qwen1_5_32b, llava_next_34b)
}

ARCH_IDS = tuple(REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch].validate()


def reduced_config(arch: str, **overrides) -> ModelConfig:
    """Small same-family config for CPU smoke tests: few layers (one full
    interleave period), narrow widths, few experts, tiny vocab."""
    cfg = get_config(arch)
    per = cfg.attn_every if cfg.family == "hybrid" else 1
    if cfg.n_experts:
        per = math.lcm(per, cfg.moe_every)
    small = dict(
        n_layers=max(2, per),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(4, max(1, cfg.n_kv_heads * 4 // cfg.n_heads)),
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        head_dim=16,
        n_experts=0 if cfg.n_experts == 0 else 4,
        top_k=min(cfg.top_k, 2),
        ssm_state=8 if cfg.ssm_state else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        n_frames=16 if cfg.family == "encdec" else cfg.n_frames,
        n_patches=8 if cfg.family == "vlm" else 0,
        dtype="float32",
        remat=False,
        tp=1,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small).validate()


__all__ = ["ARCH_IDS", "REGISTRY", "get_config", "reduced_config"]
