"""Transformer layer substrate for the dense LM: GQA attention (chunked
online softmax for train/prefill, direct attend for decode) and the SwiGLU
MLP.

Port of the JAX package's ``models/layers.py`` (dense family only).  None
of these is a Pallas kernel in the reference, so they are plain torch ops.
The numerics follow the reference's default performance flags
(``models/opt_flags.py``): prefill attention carries the probabilities in
bf16 into the AV product with fp32 accumulation (``attn_bf16_probs``), and
decode attends directly in fp32 with ``p / max(l, 1e-30)``
(``decode_direct``).  Masked scores are ``-1e30``, not ``-inf``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .common import ParamSpec, apply_rope, rms_norm, rope

__all__ = [
    "attention_specs", "mlp_specs", "MaskSpec", "attention", "attention_decode", "mlp",
]

_NEG_INF = -1e30

# --------------------------------------------------------------------------
# Specs
# --------------------------------------------------------------------------


def attention_specs(cfg) -> dict:
    d, nh, kvh, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
    specs = {
        "wq": ParamSpec((d, nh, hd)),
        "wk": ParamSpec((d, kvh, hd)),
        "wv": ParamSpec((d, kvh, hd)),
        "wo": ParamSpec((nh, hd, d)),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((nh, hd), init="zeros")
        specs["bk"] = ParamSpec((kvh, hd), init="zeros")
        specs["bv"] = ParamSpec((kvh, hd), init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), init="zeros")
        specs["k_norm"] = ParamSpec((hd,), init="zeros")
    return specs


def mlp_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f)),
        "w_up": ParamSpec((d, f)),
        "w_down": ParamSpec((f, d)),
    }


# --------------------------------------------------------------------------
# Masks
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Declarative attention mask.  The dense LM uses ``causal`` only; the
    reference's local/prefix/full kinds come with the families that need
    them (ROADMAP.md A13)."""

    kind: str = "causal"

    def __call__(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
        """(Q,) x (K,) int positions -> (Q, K) bool allow-mask."""
        if self.kind != "causal":
            raise NotImplementedError(f"mask kind {self.kind!r} is not ported yet")
        return k_pos[None, :] <= q_pos[:, None]


# --------------------------------------------------------------------------
# Attention cores
# --------------------------------------------------------------------------


def _flash_attend(
    q: torch.Tensor,  # (B, Sq, KVH, G, hd)
    k: torch.Tensor,  # (B, Sk, KVH, hd)
    v: torch.Tensor,  # (B, Sk, KVH, hd)
    mask: MaskSpec,
    q_pos: torch.Tensor,  # (Sq,)
    k_pos: torch.Tensor,  # (Sk,)
    kv_valid: Optional[torch.Tensor] = None,  # (Sk,) or (B, Sk) bool
    kv_chunk: int = 512,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks.  Returns (B, Sq, KVH, G, hd).

    Query rows are independent, so only the KV chunking (512, as the
    reference) shapes the numerics.  P and V enter the AV product rounded to
    bf16, accumulation stays fp32 — the reference's ``attn_bf16_probs``."""
    b, sq, kvh, g, hd = q.shape
    sk = k.shape[1]
    kv_chunk = min(kv_chunk, sk)
    scale = hd**-0.5
    if kv_valid is None:
        kv_valid = torch.ones((sk,), dtype=torch.bool, device=q.device)
    per_row = kv_valid.ndim == 2
    qf = q.float()
    m = torch.full((b, kvh, g, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, kv_chunk):
        ki = k[:, k0 : k0 + kv_chunk].float()
        vi = v[:, k0 : k0 + kv_chunk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, ki) * scale
        allow = mask(q_pos, k_pos[k0 : k0 + kv_chunk])  # (Q, K)
        if per_row:
            allow = (allow[None] & kv_valid[:, None, k0 : k0 + kv_chunk])[:, None, None]
        else:
            allow = allow & kv_valid[None, k0 : k0 + kv_chunk]
        s = s.masked_fill(~allow, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        av = torch.einsum(
            "bhgqk,bkhd->bhgqd",
            p.to(torch.bfloat16).float(),
            vi.to(torch.bfloat16).float(),
        )
        acc = acc * corr[..., None] + av
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def _direct_attend(
    q: torch.Tensor,  # (B, 1, KVH, G, hd) — single decode token
    k: torch.Tensor,  # (B, Sk, KVH, hd)
    v: torch.Tensor,
    mask: MaskSpec,
    q_pos: torch.Tensor,  # (1,)
    k_pos: torch.Tensor,  # (Sk,)
    kv_valid: torch.Tensor,  # (Sk,)
) -> torch.Tensor:
    """Unchunked fp32 decode attention, as the reference's ``decode_direct``."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    allow = mask(q_pos, k_pos) & kv_valid[None, :]
    s = s.masked_fill(~allow, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p / torch.clamp_min(l, 1e-30), v.float())
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)  # (B, 1, KVH, G, hd)


# --------------------------------------------------------------------------
# Attention apply (train/prefill + decode-with-cache)
# --------------------------------------------------------------------------


def _project_qkv(p, x, cfg, positions, wmm=None):
    """QKV projection.  ``wmm(name, x) -> x @ W_name`` on the flattened head
    dim optionally overrides the weight matmuls — the hook the VUSA-packed
    decode path (serve/packed.py) uses to run the projections through the
    row-packed kernel while sharing the rope/bias/norm glue."""
    b, s, d = x.shape
    nh, kvh, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    if wmm is None:
        q = torch.einsum("bsd,dnh->bsnh", x, p["wq"].to(x.dtype))
        k = torch.einsum("bsd,dnh->bsnh", x, p["wk"].to(x.dtype))
        v = torch.einsum("bsd,dnh->bsnh", x, p["wv"].to(x.dtype))
    else:
        q = wmm("wq", x).reshape(b, s, nh, hd).to(x.dtype)
        k = wmm("wk", x).reshape(b, s, kvh, hd).to(x.dtype)
        v = wmm("wv", x).reshape(b, s, kvh, hd).to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)[None, None]
        k = k + p["bk"].to(x.dtype)[None, None]
        v = v + p["bv"].to(x.dtype)[None, None]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    sin, cos = rope(positions, hd, cfg.rope_theta)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def attention(
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    cfg,
    mask: MaskSpec,
    positions: Optional[torch.Tensor] = None,  # (S,)
    kv_valid: Optional[torch.Tensor] = None,  # (B, S) bool: real keys under bucketed prefill
    return_kv: bool = False,
):
    """Full-sequence self-attention (train / prefill).  With ``return_kv``
    also returns the projected K/V rows, which prefill writes to the cache
    (the reference recomputes them; the values are the same)."""
    b, s, _ = x.shape
    nh, kvh, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    q = q.reshape(b, s, kvh, nh // kvh, hd)
    out = _flash_attend(q, k, v, mask, positions, positions, kv_valid=kv_valid)
    out = out.reshape(b, s, nh, hd)
    y = torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(x.dtype))
    return (y, k, v) if return_kv else y


def _write_rows(cache_t: torch.Tensor, positions: torch.Tensor, rows: torch.Tensor) -> None:
    """Write ``rows`` (B, s, ...) into ``cache_t`` (B, S_max, ...) at the
    consecutive slots ``positions`` (s,), in place; rows past ``S_max`` are
    dropped (the reference's ``mode="drop"``), never clamped onto the last
    slot.  A row past the end is sent to the last slot carrying that slot's
    final value (the first row aimed there, or what the slot holds), so
    every write to one slot carries the same bits and the result does not
    depend on the order the writes land in.  All on the device: no host
    sync."""
    s_max, s = cache_t.shape[1], rows.shape[1]
    idx = positions.clamp(max=s_max - 1)
    inside = (positions < s_max).view(1, s, *[1] * (rows.ndim - 2))
    src = torch.where(inside, rows.to(cache_t.dtype), cache_t.index_select(1, idx))
    if s > 1:  # row i takes the data of the first row aimed at its slot
        first = torch.minimum(torch.arange(s, device=positions.device),
                              (s_max - 1 - positions[0]).clamp(min=0))
        src = src.index_select(1, first)
    cache_t.index_copy_(1, idx, src)


def attention_decode(
    p: dict,
    x: torch.Tensor,  # (B, s, d)
    cfg,
    cache: dict,  # {"k": (B, S_max, kvh, hd), "v": ..., "pos": 0-d long tensor}
    wmm=None,  # optional weight-matmul override (see _project_qkv)
) -> torch.Tensor:
    """Decode ``s`` tokens against a contiguous KV cache; returns y (B, s, d).

    ``pos`` is a 0-d ``torch.long`` tensor on the cache's device — the
    number of tokens already cached — from which the rope positions, the
    cache write and the validity mask are derived, so the step makes no
    host sync and a CUDA graph can replay it at any position.  The new K/V
    rows are written into the cache tensors *in place* (the reference
    returns an updated copy; in place saves a full cache copy per layer and
    step); ``pos`` itself is the caller's to advance.  Rows past the cache
    end are dropped; the engine's length guard keeps decode short of it.

    With ``s > 1`` (the speculative verify) the ``s`` tokens take positions
    ``pos .. pos+s-1`` and all their K/V rows are written before attending.
    The attend then runs one query row at a time with exactly the
    single-token shapes: row ``i`` sees ``slots <= pos+i``, the sequential
    step's allow set, and the rows written past it get probability exactly
    0, so each row is bitwise the sequential step's.  Bit-parity of the
    surrounding matmuls is the caller's contract: ``wmm`` must be
    row-stable across row counts (the packed kernels are; a ``torch.matmul``
    in general is not, so the dense path chains single-token steps)."""
    b, s, d = x.shape
    nh, kvh, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    k_cache, v_cache = cache["k"], cache["v"]
    s_max = k_cache.shape[1]
    positions = cache["pos"] + torch.arange(s, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, wmm=wmm)
    _write_rows(k_cache, positions, k_new)
    _write_rows(v_cache, positions, v_new)
    slots = torch.arange(s_max, device=x.device)
    q = q.reshape(b, s, kvh, nh // kvh, hd)
    rows = [
        _direct_attend(q[:, i : i + 1].contiguous(), k_cache, v_cache, MaskSpec("causal"),
                       positions[i : i + 1], slots, slots <= positions[i])
        for i in range(s)  # s = draft_k + 1 at most: small
    ]
    out = rows[0] if s == 1 else torch.cat(rows, dim=1)
    out = out.reshape(b, s, nh, hd)
    if wmm is None:
        return torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(x.dtype))
    return wmm("wo", out.reshape(b, s, nh * hd)).to(x.dtype)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)
