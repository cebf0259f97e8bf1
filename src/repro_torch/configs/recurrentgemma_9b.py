"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 2:1 pattern.
38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000 [arXiv:2402.19427]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, kv_heads=1, d_ff=12288,
    vocab=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "attn"), local_window=2048,
    rglru_dim=4096, sparsity=0.85,
)

SMOKE = ArchConfig(
    name="recurrentgemma-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=4, kv_heads=1, d_ff=128,
    vocab=512, head_dim=16,
    block_pattern=("rglru", "rglru", "attn"), local_window=32,
    rglru_dim=64, sparsity=0.85, dtype="float32", remat=False,
)
