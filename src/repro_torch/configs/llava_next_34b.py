"""llava-next-34b [vlm]: LM backbone only; the anyres vision tower is a STUB
(input_specs supplies precomputed patch embeddings prepended to the token
stream).  [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab_size=64000, head_dim=128,
    n_patches=576,
)
