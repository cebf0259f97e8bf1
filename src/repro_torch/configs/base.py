"""Architecture + run configuration (a copy of the JAX package's
``configs/base.py``, so the port and the reference read identical configs).

Every architecture the port serves is one ``ArchConfig`` in
``repro_torch/configs/<id>.py``; ``--arch <id>`` resolves through
:func:`repro_torch.configs.get_config`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "pad_vocab"]


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a shardable multiple (loss masks the padding ids)."""
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_cf: float = 1.25  # capacity factor; >= n_experts/top_k == dropless
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_chunk: int = 256
    d_conv: int = 4
    expand: int = 2
    # hybrid (recurrentgemma / griffin)
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "attn")
    local_window: int = 0  # sliding-window size for local attention
    rglru_dim: int = 0  # recurrent width (griffin: ~ d_model)
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_frames: int = 1500  # stub audio frontend: precomputed frame embeddings
    # vlm (paligemma)
    patch_tokens: int = 0  # stub vision frontend: precomputed patch embeddings
    # sparsity (the paper's technique, first-class)
    sparsity: float = 0.0  # target unstructured weight sparsity
    vusa_m_over_a: int = 4  # block-VUSA max virtual growth M_blk/A_blk
    # misc
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab)

    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND model-FLOPs)."""
        d, v, L = self.d_model, self.padded_vocab, self.n_layers
        hd = self.hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) + 2 * d * (self.kv_heads * hd) + (self.n_heads * hd) * d
        if self.family == "moe":
            ffn = 3 * d * self.d_ff * self.n_experts
        else:
            ffn = 3 * d * self.d_ff
        if self.family == "ssm":
            din = self.expand * d
            # in_proj(z,x,B,C,dt) + out_proj + conv
            attn = 0
            ffn = d * (2 * din + 2 * self.ssm_state + self.ssm_heads) + din * d + din * self.d_conv
        body = L * (attn + ffn)
        if self.family == "hybrid":
            n_attn = sum(1 for b in self._pattern() if b == "attn")
            n_rec = L - n_attn
            rec = (
                d * (2 * self.rglru_dim) + self.rglru_dim * d
                + 2 * self.rglru_dim * self.rglru_dim // 1
            )
            body = n_attn * (attn + ffn) + n_rec * (rec + ffn)
        if self.family == "encdec":
            body = self.enc_layers * (attn + ffn) + L * (2 * attn + ffn)
        return emb + body

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts FFNs)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        hd = self.hd
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) + 2 * d * (self.kv_heads * hd) + (self.n_heads * hd) * d
        ffn = 3 * d * self.d_ff * self.top_k
        return emb + L * (attn + ffn)

    def _pattern(self) -> Tuple[str, ...]:
        if not self.block_pattern:
            return ()
        reps = (self.n_layers + len(self.block_pattern) - 1) // len(self.block_pattern)
        return (self.block_pattern * reps)[: self.n_layers]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
