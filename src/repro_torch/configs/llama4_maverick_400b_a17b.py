"""llama4-maverick-400b-a17b [moe]: 128 experts top-1 + shared expert;
early-fusion multimodality is a no-op for the text-only input specs.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202048, head_dim=128,
    n_experts=128, top_k=1, moe_every=1, shared_expert=True,
)
