"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 [arXiv:2403.17297]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, kv_heads=8, d_ff=8192,
    vocab=92544, rope_theta=1000000.0, sparsity=0.85,
)

SMOKE = ArchConfig(
    name="internlm2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
    vocab=512, sparsity=0.85, dtype="float32", remat=False,
)
