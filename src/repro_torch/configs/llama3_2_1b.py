"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-1B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, kv_heads=8, d_ff=8192,
    vocab=128256, rope_theta=500000.0, tie_embeddings=True, sparsity=0.85,
)

SMOKE = ArchConfig(
    name="llama3.2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
    vocab=512, tie_embeddings=True, sparsity=0.85, dtype="float32", remat=False,
)
