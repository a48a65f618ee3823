"""Composable model configuration covering all assigned architecture
families: dense / MoE / SSM / hybrid / encoder-decoder / VLM backbones
(port of ``repro.models.config``: the same fields, defaults and derived
shapes; ``torch_dtype`` replaces ``jdtype``)."""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..parallel.sharding import pad_to_multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: int = 64

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 2
    moe_every: int = 1           # MoE replaces the MLP every k-th layer
    dense_residual: bool = False # arctic: parallel dense FFN next to MoE
    shared_expert: bool = False  # llama4: always-on shared expert
    capacity_factor: float = 1.25

    # --- SSM / hybrid ---
    ssm_state: int = 0
    d_conv: int = 4
    attn_every: int = 0          # hybrid: 1 attention layer per this many
                                 # (0 = pure attention, -1 = attention-free)

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    n_frames: int = 1500         # stub audio frontend context

    # --- VLM (llava) ---
    n_patches: int = 0           # stub vision frontend patches

    # --- misc ---
    norm: str = "rmsnorm"        # rmsnorm | layernorm | nonparametric
    mlp: str = "swiglu"          # swiglu | gelu
    qkv_bias: bool = False
    pos_embed: str = "rope"      # rope | learned
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # kept for the reference's configs; the port runs its layers as a
    # ModuleList, eagerly, so neither changes a result
    remat: bool = True
    scan_layers: bool = True
    # "chunked" = padded-head attention (the port calls the flash op on
    # every length); "ring" = sequence-parallel ring attention (raises
    # until the multi-device slice)
    attn_impl: str = "chunked"
    attn_chunk: int = 1024
    mamba_chunk: int = 256
    ssm_dtype: str = "float32"
    ssm_impl: str = "scan"

    # --- sharding-derived (computed) ---
    tp: int = 16                 # model-axis size the padded dims target

    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            self.dtype]

    def ssm_torch_dtype(self) -> torch.dtype:
        """The scan's state dtype; any other ``ssm_dtype`` raises a
        ``KeyError``, as the reference's ``apply_mamba`` does."""
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            self.ssm_dtype]

    @property
    def d_inner(self) -> int:   # mamba inner width
        return 2 * self.d_model

    @property
    def dt_rank(self) -> int:
        return math.ceil(self.d_model / 16)

    @property
    def padded_heads(self) -> int:
        """Query heads padded so TP divides them (zero-padded output rows
        keep the math exact).  Ring mode shards sequence instead of heads
        -> no padding."""
        if self.attn_impl == "ring":
            return self.n_heads
        return pad_to_multiple(self.n_heads, self.tp)

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, self.tp * 8)

    @property
    def group_size(self) -> int:  # query heads per KV head (GQA)
        return self.n_heads // self.n_kv_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer sequence of "attn" / "mamba" mixers."""
        if self.family == "ssm":
            return ("mamba",) * self.n_layers
        if self.family == "hybrid":
            k = self.attn_every
            if not (k > 0 and self.n_layers % k == 0):
                raise ValueError(f"{self.name}: attn_every {k} does not "
                                 f"divide n_layers {self.n_layers}")
            return tuple("attn" if (i % k) == (k - 1) else "mamba"
                         for i in range(self.n_layers))
        return ("attn",) * self.n_layers

    def ffn_kinds(self) -> Tuple[str, ...]:
        """Per-layer "mlp" / "moe" feed-forward selector."""
        if self.n_experts == 0:
            return ("mlp",) * self.n_layers
        return tuple(
            "moe" if (i % self.moe_every) == (self.moe_every - 1) else "mlp"
            for i in range(self.n_layers))

    def validate(self):
        """The reference's checks, raised as ``ValueError`` (they guard
        outside input, so they must survive ``python -O``)."""
        checks = [
            (self.d_model % self.tp == 0, "d_model % tp"),
            (self.d_ff % self.tp == 0 or self.d_ff == 0, "d_ff % tp"),
            (not self.n_experts or self.n_experts % self.tp == 0,
             "experts % tp"),
            (self.n_heads % self.n_kv_heads == 0, "n_heads % n_kv_heads"),
        ]
        for ok, what in checks:
            if not ok:
                raise ValueError(f"{self.name}: {what} != 0")
        return self
