"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, 64 experts top-6 [hf:moonshotai/Moonlight-16B-A3B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, kv_heads=16, d_ff=1408,
    vocab=163840, n_experts=64, top_k=6, sparsity=0.85,
)

SMOKE = ArchConfig(
    name="moonshot-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=32,
    vocab=512, n_experts=8, top_k=2, moe_cf=4.0, sparsity=0.85, dtype="float32",
    remat=False,
)
