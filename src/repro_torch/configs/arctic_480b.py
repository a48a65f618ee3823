"""arctic-480b [moe]: 128 experts top-2 + parallel dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab_size=32000, head_dim=128,
    n_experts=128, top_k=2, moe_every=1, dense_residual=True,
)
