"""falcon-mamba-7b [ssm]: attention-free Mamba-1 stack, d_inner = 2*d_model,
no MLP (d_ff=0).  [arXiv:2410.05355; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=0,
    vocab_size=65024, head_dim=128,
    ssm_state=16, d_conv=4, attn_every=-1,
)
