"""mamba2-2.7b [ssm]: 64L d_model=2560 attn-free, ssm_state=128; SSD
(state-space duality) [arXiv:2405.21060]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_heads=80, ssm_chunk=256,
    expand=2, d_conv=4, sparsity=0.85,
)

SMOKE = ArchConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, kv_heads=0, d_ff=0,
    vocab=512, ssm_state=16, ssm_heads=4, ssm_chunk=32,
    expand=2, d_conv=4, sparsity=0.85, dtype="float32", remat=False,
)
