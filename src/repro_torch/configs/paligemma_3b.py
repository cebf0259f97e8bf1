"""paligemma-3b [vlm]: gemma backbone 18L d_model=2048 8H (MQA kv=1)
d_ff=16384 vocab=257216; SigLIP tower STUB (the batch's ``patches`` carry 256
precomputed patch embeddings) [arXiv:2407.07726]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, kv_heads=1, d_ff=16384,
    vocab=257216, head_dim=256, patch_tokens=256, sparsity=0.85,
)

SMOKE = ArchConfig(
    name="paligemma-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, kv_heads=1, d_ff=128,
    vocab=512, head_dim=16, patch_tokens=8, sparsity=0.85,
    dtype="float32", remat=False,
)
