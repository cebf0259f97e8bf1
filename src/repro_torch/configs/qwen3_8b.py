"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936; qk_norm [hf:Qwen/Qwen3-8B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, kv_heads=8, d_ff=12288,
    vocab=151936, qk_norm=True, rope_theta=1000000.0, sparsity=0.85,
)

SMOKE = ArchConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
    vocab=512, qk_norm=True, sparsity=0.85, dtype="float32", remat=False,
)
