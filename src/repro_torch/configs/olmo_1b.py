"""olmo-1b [dense]: non-parametric LayerNorm (no scale/bias), MHA.
[arXiv:2402.00838; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab_size=50304, head_dim=128,
    norm="nonparametric",
)
