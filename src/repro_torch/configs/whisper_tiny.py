"""whisper-tiny [audio enc-dec]: 4L enc + 4L dec, d_model=384 6H d_ff=1536
vocab=51865; conv frontend STUB (input_specs provides frame embeddings)
[arXiv:2212.04356]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, enc_layers=4, d_model=384, n_heads=6, kv_heads=6, d_ff=1536,
    vocab=51865, enc_frames=1500, sparsity=0.85,
)

SMOKE = ArchConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
    vocab=512, enc_frames=16, sparsity=0.85, dtype="float32", remat=False,
)
