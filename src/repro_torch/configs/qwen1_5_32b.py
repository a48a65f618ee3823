"""qwen1.5-32b [dense]: MHA with QKV bias, wide FFN.
[hf:Qwen/Qwen1.5-0.5B; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27392,
    vocab_size=152064, head_dim=128,
    qkv_bias=True,
)
