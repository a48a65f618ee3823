"""whisper-small [audio]: 12+12 enc-dec backbone; conv audio frontend is a
STUB (input_specs supplies precomputed frame embeddings).  vocab 51865 is
padded to the TP multiple (51872+) for vocab-parallel sharding.
[arXiv:2212.04356; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, encoder_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    norm="layernorm", mlp="gelu", pos_embed="learned", n_frames=1500,
)
