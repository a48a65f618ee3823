"""granite-34b [dense]: 88-layer MQA (kv=1) code model; the single KV head
is group-replicated across TP shards (exact).  [arXiv:2405.04324; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab_size=49152, head_dim=128,
)
