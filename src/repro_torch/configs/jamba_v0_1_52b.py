"""jamba-v0.1-52b [hybrid]: Mamba+attention 1:7 interleave, MoE every other
layer (16e top-2).  [arXiv:2403.19887; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536, head_dim=128,
    n_experts=16, top_k=2, moe_every=2,
    ssm_state=16, d_conv=4, attn_every=8,
    rope_theta=1e6,
)
