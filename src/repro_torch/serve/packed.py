"""VUSA-packed decode path for the dense LM family.

Port of the JAX package's ``serve/packed.py`` (dense values, one device).
``pack_lm_weights`` packs the decode-step weights into the row-wise VUSA
format: per-layer MLP matrices (``w_gate``/``w_up`` plain, ``w_down``
*transposed* so the fused kernel can window its reduction dim) and, with
``scope="all"``, the attention projections ``wq/wk/wv/wo`` and the untied
LM head.  ``lm_decode_step_packed`` is the twin of
``families.lm_decode_step`` whose matmuls run through the hand-written CUDA
kernels: the MLP through ``vusa_fused_mlp_matmul`` (or, with
``fused_mlp=False``, three ``vusa_packed_matmul`` calls), the projections
and the vocab-wide head through ``vusa_packed_matmul``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.packing import pack_rows, pack_rows_t
from ..kernels.ops import RowPackedLinear, apply_fused_mlp, apply_row_packed, linear_from_pack
from ..models.common import rms_norm
from ..models.families import _embed_tokens, layer_params
from ..models.layers import attention_decode

__all__ = [
    "pack_lm_weights", "lm_decode_step_packed", "packed_byte_ratios", "validate_packed",
]

ATTN_NAMES = ("wq", "wk", "wv", "wo")


# --------------------------------------------------------------------------
# packers
# --------------------------------------------------------------------------


def _stack_packs(packs) -> Dict:
    """Stack per-layer packs into one (L, T, K, S) entry.  Slots are padded
    to the max over layers so the stack is rectangular; padded slots are
    exact no-ops (value 0, position -1)."""
    smax = max(p.slots for p in packs)

    def pad(p: RowPackedLinear):
        extra = smax - p.slots
        return (F.pad(p.values, (0, extra)), F.pad(p.positions, (0, extra), value=-1))

    vs, qs = zip(*(pad(p) for p in packs))
    p0 = packs[0]
    return {
        "values": torch.stack(vs), "positions": torch.stack(qs),
        "k": p0.k, "c": p0.c, "m": p0.m, "a": p0.a,
    }


def _stack_layers(ws: torch.Tensor, m: int, a: int, transposed: bool = False) -> Dict:
    """Pack every layer of a stacked (L, K, C) weight (packing (L, C, K)'s
    transposes with ``transposed``) and stack the packs on its device."""
    host = ws.detach().to("cpu", torch.float32).numpy()  # one copy for all layers
    pack = pack_rows_t if transposed else pack_rows
    return _stack_packs([
        linear_from_pack(pack(host[layer], m=m, a=a), ws.dtype, ws.device)
        for layer in range(host.shape[0])
    ])


def _as_linear(entry: Dict, layer: Optional[int] = None) -> RowPackedLinear:
    """A pack entry (or layer ``layer`` of a stacked one) as a linear."""
    values, positions = entry["values"], entry["positions"]
    if layer is not None:
        values, positions = values[layer], positions[layer]
    return RowPackedLinear(values=values, positions=positions,
                           k=entry["k"], c=entry["c"], a=entry["a"], m=entry["m"])


def pack_lm_weights(
    cfg: ArchConfig,
    params,
    m: int = 128,
    a: int = 16,
    scope: str = "all",
    fused_mlp: bool = True,
) -> Dict:
    """Pack the dense-family decode-step weights; returns a structured dict
    ``{"mlp", "attn", "head", "scope", "fused_mlp"}`` laid out as the
    reference's.  Packs land on the parameters' device and keep their dtype.

    ``scope="mlp"`` packs only the per-layer MLP trio; ``scope="all"`` adds
    the attention projections (head dims flattened to 2-D, ``wo`` as
    ``(L, nh*hd, d)``) and the untied LM head (tied embeddings keep the
    dense transposed-embedding product).  ``fused_mlp`` selects the fused
    kernel's layout (``w_down`` packed transposed) over the three-call
    layout (``w_down`` packed plain)."""
    if cfg.family != "dense":
        raise ValueError("the packed decode path targets the dense family")
    if scope not in ("mlp", "all"):
        raise ValueError(f"scope must be 'mlp' or 'all', got {scope!r}")
    ffn = params["layers"]["ffn"]
    mlp: Dict = {name: _stack_layers(ffn[name], m, a) for name in ("w_gate", "w_up")}
    if fused_mlp:
        mlp["w_down_t"] = _stack_layers(ffn["w_down"], m, a, transposed=True)
    else:
        mlp["w_down"] = _stack_layers(ffn["w_down"], m, a)
    out: Dict = {"mlp": mlp, "attn": None, "head": None, "scope": scope, "fused_mlp": fused_mlp}
    if scope == "all":
        attn_p = params["layers"]["attn"]
        attn: Dict = {}
        for name in ATTN_NAMES:
            w = attn_p[name]  # (L, d, nh, hd) or (L, nh, hd, d)
            flat = (
                w.reshape(w.shape[0], -1, w.shape[-1])  # wo: (L, nh*hd, d)
                if name == "wo"
                else w.reshape(w.shape[0], w.shape[1], -1)  # q/k/v: (L, d, nh*hd)
            )
            attn[name] = _stack_layers(flat, m, a)
        out["attn"] = attn
        if not cfg.tie_embeddings:
            w = params["lm_head"]
            host = w.detach().to("cpu", torch.float32).numpy()
            p = linear_from_pack(pack_rows(host, m=m, a=a), w.dtype, w.device)
            out["head"] = {"values": p.values, "positions": p.positions,
                           "k": p.k, "c": p.c, "m": p.m, "a": p.a}
    validate_packed(out)  # pack-time guard: never hand out a malformed pack
    return out


def _flat_entries(packed: Dict) -> Dict[str, Dict]:
    flat: Dict[str, Dict] = dict(packed["mlp"])
    if packed.get("attn"):
        flat.update(packed["attn"])
    if packed.get("head") is not None:
        flat["lm_head"] = packed["head"]
    return flat


def validate_packed(packed: Dict) -> None:
    """Check every pack entry's structural invariants; raise ``ValueError``
    naming the entry and the first violation.  A corrupt position byte
    reconstructs a weight into the wrong lane — finite and wrong — which no
    runtime check of the outputs can see, so the pack is checked before it
    is served."""
    flat = _flat_entries(packed)
    if not flat:
        raise ValueError("empty pack: no entries to serve")
    for name, e in flat.items():
        v, q = e["values"], e["positions"]
        m, a, k, c = e["m"], e["a"], e["k"], e["c"]
        if tuple(v.shape) != tuple(q.shape):
            raise ValueError(f"{name}: values shape {tuple(v.shape)} != positions {tuple(q.shape)}")
        if q.dtype != torch.int8:
            raise ValueError(f"{name}: positions dtype must be int8, got {q.dtype}")
        if v.ndim not in (3, 4):
            raise ValueError(f"{name}: expected (T, K, S) or (L, T, K, S), got {tuple(v.shape)}")
        if m < 1 or a < 1 or m > 128:
            raise ValueError(f"{name}: window m={m} / slots a={a} out of range (int8 lanes)")
        if v.shape[-2] != k:
            raise ValueError(f"{name}: pack rows {v.shape[-2]} != declared k={k}")
        if v.shape[-1] % a:
            raise ValueError(f"{name}: slot count {v.shape[-1]} not a multiple of a={a}")
        if v.shape[-3] * m < c:
            raise ValueError(
                f"{name}: {v.shape[-3]} windows of {m} lanes cover {v.shape[-3] * m} < c={c} columns"
            )
        # widen before comparing: m=128 does not fit int8
        qw = q.to(torch.int32)
        bad = (qw < -1) | (qw >= m)
        if bool(bad.any()):
            i = tuple(int(x) for x in torch.nonzero(bad)[0])
            raise ValueError(
                f"{name}: position {int(q[i])} at {i} outside [-1, {m}) — corrupt metadata"
            )
        if not bool(torch.isfinite(v).all()):
            i = tuple(int(x) for x in torch.nonzero(~torch.isfinite(v))[0])
            raise ValueError(f"{name}: non-finite packed value at {i}")


def packed_byte_ratios(packed: Dict, value_bytes: Optional[int] = None) -> Dict[str, float]:
    """Per-weight and total packed/dense device-memory byte ratios (values
    plus int8 positions against the dense weight in the same value dtype).
    ``value_bytes`` defaults to the packed value itemsize."""
    ratios: Dict[str, float] = {}
    tot_packed = tot_dense = 0
    for name, e in _flat_entries(packed).items():
        v = e["values"]
        n_layers = v.shape[0] if v.ndim == 4 else 1
        vb = v.element_size() if value_bytes is None else value_bytes
        pb = v.numel() * (vb + 1)
        db = n_layers * e["k"] * e["c"] * vb
        ratios[name] = pb / db
        tot_packed += pb
        tot_dense += db
    ratios["total"] = tot_packed / max(tot_dense, 1)
    return ratios


# --------------------------------------------------------------------------
# decode step
# --------------------------------------------------------------------------


def lm_decode_step_packed(params, packed, token, cache, cfg):
    """One-token decode step with VUSA-packed weights (dense family).
    token: (B, 1).  Returns (logits (B, 1, V), cache with ``pos + 1``); the
    cache tensors are updated in place."""
    if cfg.family != "dense":
        raise ValueError("the packed decode path targets the dense family")
    if token.shape[1] != 1:
        raise NotImplementedError(
            "multi-token packed decode (speculative verify) is not ported yet: ROADMAP.md A9"
        )
    mlp, attn = packed["mlp"], packed["attn"]
    fused = packed.get("fused_mlp", "w_down_t" in mlp)
    x = _embed_tokens(params, token, cfg)
    pos = cache["pos"]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        wmm = None
        if attn is not None:
            def wmm(name, x2, i=i):
                return apply_row_packed(x2, _as_linear(attn[name], i))

        y, _ = attention_decode(
            lp["attn"], rms_norm(x, lp["norm1"]), cfg,
            {"k": cache["k"][i], "v": cache["v"][i], "pos": pos}, wmm=wmm,
        )
        x = x + y
        h = rms_norm(x, lp["norm2"])
        b, s, d = h.shape
        hf = h.reshape(b * s, d)
        if fused:
            y2 = apply_fused_mlp(
                hf, _as_linear(mlp["w_gate"], i), _as_linear(mlp["w_up"], i),
                _as_linear(mlp["w_down_t"], i),
            )
        else:  # three calls: gate/up/down round-trip the (B, ff) hidden state
            gate = F.silu(apply_row_packed(hf, _as_linear(mlp["w_gate"], i)))
            up = apply_row_packed(hf, _as_linear(mlp["w_up"], i))
            y2 = apply_row_packed((gate * up).to(hf.dtype), _as_linear(mlp["w_down"], i))
        x = x + y2.reshape(b, s, d).to(x.dtype)
    x = rms_norm(x, params["final_norm"])
    if packed.get("head") is not None:
        b, s, d = x.shape
        logits = apply_row_packed(x.reshape(b * s, d), _as_linear(packed["head"])).reshape(b, s, -1)
    else:
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = torch.einsum("bsd,dv->bsv", x, head.to(x.dtype))
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
