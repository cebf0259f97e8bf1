"""The paper's own operating point: an Edge-AI scale LM whose linear layers
run VUSA-packed (N=3,M=6,A=3 semantics at block granularity M/A=2)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="vusa-edge", family="dense",
    n_layers=12, d_model=768, n_heads=12, kv_heads=12, d_ff=3072,
    vocab=32000, sparsity=0.85, vusa_m_over_a=2,
)

SMOKE = ArchConfig(
    name="vusa-edge-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
    vocab=512, sparsity=0.85, vusa_m_over_a=2, dtype="float32", remat=False,
)
