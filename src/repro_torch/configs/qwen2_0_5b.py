"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936; QKV bias [arXiv:2407.10671]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, kv_heads=2, d_ff=4864,
    vocab=151936, qkv_bias=True, rope_theta=1000000.0, tie_embeddings=True,
    sparsity=0.85,
)

SMOKE = ArchConfig(
    name="qwen2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
    vocab=512, qkv_bias=True, tie_embeddings=True, sparsity=0.85,
    dtype="float32", remat=False,
)
