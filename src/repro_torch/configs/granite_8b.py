"""granite-8b [dense]: llama-arch code model, GQA 32H/8KV.
[arXiv:2405.04324; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=49152, head_dim=128,
)
