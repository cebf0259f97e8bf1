"""VUSA-packed decode path for the dense LM family.

Port of the JAX package's ``serve/packed.py`` (one device).
``pack_lm_weights`` packs the decode-step weights into the row-wise VUSA
format: per-layer MLP matrices (``w_gate``/``w_up`` plain, ``w_down``
*transposed* so the fused kernel can window its reduction dim) and, with
``scope="all"``, the attention projections ``wq/wk/wv/wo`` and the untied
LM head.  ``value_dtype="int8"``/``"int4"`` quantizes every pack's value
slots with per-(window, row) fp32 scales; ``qdq_lm_params`` is the dense
oracle of that path (every packed matrix quantized and dequantized under
the same window geometry).  ``lm_decode_step_packed`` is the twin of
``families.lm_decode_step`` whose matmuls run through the hand-written CUDA
kernels: the MLP through ``vusa_fused_mlp_matmul`` (or, with
``fused_mlp=False``, three ``vusa_packed_matmul`` calls), the projections
and the vocab-wide head through ``vusa_packed_matmul``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.packing import dequantize_rows, pack_rows, pack_rows_t, quantize_rows, unpack_rows
from ..kernels.ops import RowPackedLinear, apply_fused_mlp, apply_row_packed, linear_from_pack
from ..models.common import rms_norm
from ..models.families import _embed_tokens, layer_params
from ..models.layers import attention_decode

__all__ = [
    "pack_lm_weights", "lm_decode_step_packed", "packed_byte_ratios", "validate_packed",
    "qdq_lm_params",
]

ATTN_NAMES = ("wq", "wk", "wv", "wo")


# --------------------------------------------------------------------------
# packers
# --------------------------------------------------------------------------


def _entry(p: RowPackedLinear, values, positions, scales=None) -> Dict:
    out = {"values": values, "positions": positions, "k": p.k, "c": p.c, "m": p.m, "a": p.a}
    if p.value_dtype != "dense":
        out.update(scales=scales, value_dtype=p.value_dtype, dense_itemsize=p.dense_itemsize)
    return out


def _stack_packs(packs) -> Dict:
    """Stack per-layer packs into one (L, T, K, S) entry.  Slots are padded
    to the max over layers so the stack is rectangular; padded slots are
    exact no-ops (position -1; float values 0, quantized value bytes 0,
    int4 two slots per byte).  Quantized packs stack their (T, K) scales."""
    smax = max(p.slots for p in packs)
    nib = 2 if packs[0].value_dtype == "int4" else 1

    def pad(p: RowPackedLinear):
        return (F.pad(p.values, (0, smax // nib - p.values.shape[2])),
                F.pad(p.positions, (0, smax - p.slots), value=-1))

    vs, qs = zip(*(pad(p) for p in packs))
    scales = None if packs[0].scales is None else torch.stack([p.scales for p in packs])
    return _entry(packs[0], torch.stack(vs), torch.stack(qs), scales)


def _pack_weight(w: torch.Tensor, host: np.ndarray, m: int, a: int, transposed: bool,
                 value_dtype: str) -> RowPackedLinear:
    """Pack ``host`` (fp32 numpy of one (K, C) matrix of ``w``) onto ``w``'s
    device: float values in ``w``'s dtype, or quantized values whose byte
    ratio counts ``w``'s own element size."""
    rp = (pack_rows_t if transposed else pack_rows)(host, m=m, a=a)
    return linear_from_pack(rp, w.dtype, w.device, value_dtype, w.element_size())


def _stack_layers(ws: torch.Tensor, m: int, a: int, transposed: bool = False,
                  value_dtype: str = "dense") -> Dict:
    """Pack every layer of a stacked (L, K, C) weight (packing (L, C, K)'s
    transposes with ``transposed``) and stack the packs on its device."""
    host = ws.detach().to("cpu", torch.float32).numpy()  # one copy for all layers
    return _stack_packs([
        _pack_weight(ws, host[layer], m, a, transposed, value_dtype)
        for layer in range(host.shape[0])
    ])


def _as_linear(entry: Dict, layer: Optional[int] = None) -> RowPackedLinear:
    """A pack entry (or layer ``layer`` of a stacked one) as a linear."""
    values, positions, scales = entry["values"], entry["positions"], entry.get("scales")
    if layer is not None:
        values, positions = values[layer], positions[layer]
        scales = None if scales is None else scales[layer]
    return RowPackedLinear(values=values, positions=positions,
                           k=entry["k"], c=entry["c"], a=entry["a"], m=entry["m"],
                           scales=scales, value_dtype=entry.get("value_dtype", "dense"),
                           dense_itemsize=entry.get("dense_itemsize"))


def _flat_attn(w: torch.Tensor, name: str) -> torch.Tensor:
    """An attention projection's stacked weight as (L, K, C): q/k/v
    (L, d, nh, hd) -> (L, d, nh*hd), wo (L, nh, hd, d) -> (L, nh*hd, d)."""
    if name == "wo":
        return w.reshape(w.shape[0], -1, w.shape[-1])
    return w.reshape(w.shape[0], w.shape[1], -1)


def pack_lm_weights(
    cfg: ArchConfig,
    params,
    m: int = 128,
    a: int = 16,
    scope: str = "all",
    fused_mlp: bool = True,
    value_dtype: str = "dense",
) -> Dict:
    """Pack the dense-family decode-step weights; returns a structured dict
    ``{"mlp", "attn", "head", "scope", "fused_mlp"}`` laid out as the
    reference's.  Packs land on the parameters' device.

    ``scope="mlp"`` packs only the per-layer MLP trio; ``scope="all"`` adds
    the attention projections (head dims flattened to 2-D, ``wo`` as
    ``(L, nh*hd, d)``) and the untied LM head (tied embeddings keep the
    dense transposed-embedding product).  ``fused_mlp`` selects the fused
    kernel's layout (``w_down`` packed transposed) over the three-call
    layout (``w_down`` packed plain).  ``value_dtype="dense"`` keeps the
    parameters' float dtype; ``"int8"``/``"int4"`` quantize every pack's
    value slots with per-(window, row) fp32 scales."""
    if cfg.family != "dense":
        raise ValueError("the packed decode path targets the dense family")
    if scope not in ("mlp", "all"):
        raise ValueError(f"scope must be 'mlp' or 'all', got {scope!r}")
    ffn = params["layers"]["ffn"]
    mlp: Dict = {
        name: _stack_layers(ffn[name], m, a, value_dtype=value_dtype)
        for name in ("w_gate", "w_up")
    }
    if fused_mlp:
        mlp["w_down_t"] = _stack_layers(ffn["w_down"], m, a, True, value_dtype)
    else:
        mlp["w_down"] = _stack_layers(ffn["w_down"], m, a, value_dtype=value_dtype)
    out: Dict = {"mlp": mlp, "attn": None, "head": None, "scope": scope, "fused_mlp": fused_mlp}
    if scope == "all":
        attn_p = params["layers"]["attn"]
        out["attn"] = {
            name: _stack_layers(_flat_attn(attn_p[name], name), m, a, value_dtype=value_dtype)
            for name in ATTN_NAMES
        }
        if not cfg.tie_embeddings:
            w = params["lm_head"]
            host = w.detach().to("cpu", torch.float32).numpy()
            p = _pack_weight(w, host, m, a, False, value_dtype)
            out["head"] = _entry(p, p.values, p.positions, p.scales)
    validate_packed(out)  # pack-time guard: never hand out a malformed pack
    return out


def _flat_entries(packed: Dict) -> Dict[str, Dict]:
    flat: Dict[str, Dict] = dict(packed["mlp"])
    if packed.get("attn"):
        flat.update(packed["attn"])
    if packed.get("head") is not None:
        flat["lm_head"] = packed["head"]
    return flat


def _first(mask: torch.Tensor):
    return tuple(int(x) for x in torch.nonzero(mask)[0])


def _validate_quantized(name: str, e: Dict, vdt: str) -> None:
    """Quantized values are raw int8 bytes (two slots per byte for int4)
    that must decode to exactly the position slots, with one finite,
    positive fp32 scale per (window, row)."""
    v, q = e["values"], e["positions"]
    nib = 2 if vdt == "int4" else 1
    if v.dtype != torch.int8:
        raise ValueError(f"{name}: quantized values dtype must be int8, got {v.dtype}")
    if tuple(v.shape[:-1]) != tuple(q.shape[:-1]) or v.shape[-1] * nib != q.shape[-1]:
        raise ValueError(
            f"{name}: {vdt} values shape {tuple(v.shape)} does not decode to "
            f"positions {tuple(q.shape)}"
        )
    s = e.get("scales")
    if s is None:
        raise ValueError(f"{name}: {vdt} pack is missing its scales")
    if tuple(s.shape) != tuple(q.shape[:-1]):
        raise ValueError(
            f"{name}: scales shape {tuple(s.shape)} != window/row shape {tuple(q.shape[:-1])}"
        )
    if not bool(torch.isfinite(s).all()):
        raise ValueError(f"{name}: non-finite dequant scale at {_first(~torch.isfinite(s))}")
    if bool((s <= 0).any()):
        raise ValueError(f"{name}: non-positive dequant scale at {_first(s <= 0)}")


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
        vdt = e.get("value_dtype", "dense")
        if vdt == "dense":
            if tuple(v.shape) != tuple(q.shape):
                raise ValueError(
                    f"{name}: values shape {tuple(v.shape)} != positions {tuple(q.shape)}"
                )
        else:
            _validate_quantized(name, e, vdt)
        if q.dtype != torch.int8:
            raise ValueError(f"{name}: positions dtype must be int8, got {q.dtype}")
        if q.ndim not in (3, 4):
            raise ValueError(f"{name}: expected (T, K, S) or (L, T, K, S), got {tuple(q.shape)}")
        if m < 1 or a < 1 or m > 128:
            raise ValueError(f"{name}: window m={m} / slots a={a} out of range (int8 lanes)")
        if q.shape[-2] != k:
            raise ValueError(f"{name}: pack rows {q.shape[-2]} != declared k={k}")
        # int4 pads the slot axis to even when it quantizes, which can break
        # the a-multiple; the kernels never read ``a``, so only dense and int8
        # packs keep the check (as the reference does)
        if vdt != "int4" and v.shape[-1] % a:
            raise ValueError(f"{name}: slot count {v.shape[-1]} not a multiple of a={a}")
        if q.shape[-3] * m < c:
            raise ValueError(
                f"{name}: {q.shape[-3]} windows of {m} lanes cover {q.shape[-3] * m} "
                f"< c={c} columns"
            )
        # widen before comparing: m=128 does not fit int8
        qw = q.to(torch.int32)
        bad = (qw < -1) | (qw >= m)
        if bool(bad.any()):
            i = _first(bad)
            raise ValueError(
                f"{name}: position {int(q[i])} at {i} outside [-1, {m}) — corrupt metadata"
            )
        if vdt == "dense" and not bool(torch.isfinite(v).all()):
            raise ValueError(f"{name}: non-finite packed value at {_first(~torch.isfinite(v))}")


def packed_byte_ratios(packed: Dict, value_bytes: Optional[int] = None) -> Dict[str, float]:
    """Per-weight and total packed/dense device-memory byte ratios.

    Float entries count values plus int8 positions against the dense weight
    in the same value dtype (``value_bytes`` defaults to the packed value
    itemsize).  Quantized entries count their real bytes (value bytes, int8
    positions, fp32 scales) against the *original* dense weight's bytes
    (``dense_itemsize``, or ``value_bytes`` when given)."""
    ratios: Dict[str, float] = {}
    tot_packed = tot_dense = 0
    for name, e in _flat_entries(packed).items():
        v = e["values"]
        n_layers = v.shape[0] if v.ndim == 4 else 1
        if e.get("value_dtype", "dense") == "dense":
            vb = v.element_size() if value_bytes is None else value_bytes
            pb = v.numel() * (vb + 1)
            db = n_layers * e["k"] * e["c"] * vb
        else:
            s = e["scales"]
            pb = (v.numel() * v.element_size() + e["positions"].numel()
                  + s.numel() * s.element_size())
            dense_b = e["dense_itemsize"] if value_bytes is None else value_bytes
            db = n_layers * e["k"] * e["c"] * dense_b
        ratios[name] = pb / db
        tot_packed += pb
        tot_dense += db
    ratios["total"] = tot_packed / max(tot_dense, 1)
    return ratios


# --------------------------------------------------------------------------
# quantize-dequantize dense oracle
# --------------------------------------------------------------------------


def _qdq_matrix(w2d: np.ndarray, m: int, a: int, value_dtype: str, transposed: bool = False):
    """Quantize->dequantize one 2-D matrix under the *same* window geometry
    the packer uses (``pack_rows_t`` for transposed packs), so the values
    are bitwise the fp32 products ``q * scale`` the kernels rebuild."""
    pack = (pack_rows_t if transposed else pack_rows)(w2d, m=m, a=a)
    dense = unpack_rows(dequantize_rows(quantize_rows(pack, value_dtype)))
    return np.ascontiguousarray(dense.T) if transposed else dense


def _qdq_stack(ws: torch.Tensor, m: int, a: int, value_dtype: str,
               transposed: bool = False) -> torch.Tensor:
    host = ws.detach().to("cpu", torch.float32).numpy()
    out = np.stack([_qdq_matrix(host[i], m, a, value_dtype, transposed)
                    for i in range(host.shape[0])])
    return torch.from_numpy(out).to(ws.device, ws.dtype)


def qdq_lm_params(
    cfg: ArchConfig,
    params,
    m: int = 128,
    a: int = 16,
    scope: str = "all",
    fused_mlp: bool = True,
    value_dtype: str = "int8",
):
    """Dense-oracle params: every matrix ``pack_lm_weights`` would quantize
    is replaced by its quantize-dequantize roundtrip under identical window
    geometry and orientation, in the parameter's own dtype and device.
    The dense decode step on these params computes with the same
    ``q * scale`` values as the quantized packed step."""
    if scope not in ("mlp", "all"):
        raise ValueError(f"scope must be 'mlp' or 'all', got {scope!r}")
    ffn = dict(params["layers"]["ffn"])
    for name in ("w_gate", "w_up", "w_down"):
        ffn[name] = _qdq_stack(ffn[name], m, a, value_dtype, name == "w_down" and fused_mlp)
    layers = {**params["layers"], "ffn": ffn}
    out = {**params, "layers": layers}
    if scope == "all":
        attn = dict(params["layers"]["attn"])
        for name in ATTN_NAMES:
            w = attn[name]
            attn[name] = _qdq_stack(_flat_attn(w, name), m, a, value_dtype).reshape(w.shape)
        layers["attn"] = attn
        if not cfg.tie_embeddings:
            out["lm_head"] = _qdq_stack(params["lm_head"][None], m, a, value_dtype)[0]
    return out


# --------------------------------------------------------------------------
# decode step
# --------------------------------------------------------------------------


def _full_pack(packed) -> bool:
    """Every matmul of the step packed: scope "all" with a packed head."""
    return packed.get("attn") is not None and packed.get("head") is not None


def lm_decode_step_packed(params, packed, token, cache, cfg):
    """Decode step with VUSA-packed weights (dense family).  token: (B, 1),
    or (B, s) for the speculative verify.  Returns (logits (B, s, V), cache
    with ``pos + s``); the cache tensors and the device scalar ``pos`` are
    updated in place (see ``families.lm_decode_step``).

    A *full* pack (``_full_pack``) verifies the s tokens in one batched
    pass: every matmul goes through the packed kernels with B*s rows, whose
    row b does not depend on the row count (bitwise), and
    ``attention_decode`` attends one query row at a time, so the pass is
    bitwise s sequential steps.  A partial pack still routes some rows
    through ``torch.matmul``, which is not row-stable, so it chains s
    single-token steps, as the reference does."""
    if cfg.family != "dense":
        raise ValueError("the packed decode path targets the dense family")
    if token.shape[1] > 1 and not _full_pack(packed):
        logits = []
        for i in range(token.shape[1]):
            lg, cache = lm_decode_step_packed(params, packed, token[:, i : i + 1], cache, cfg)
            logits.append(lg)
        return torch.cat(logits, dim=1), cache
    mlp, attn = packed["mlp"], packed["attn"]
    fused = packed.get("fused_mlp", "w_down_t" in mlp)
    x = _embed_tokens(params, token, cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        wmm = None
        if attn is not None:
            def wmm(name, x2, i=i):
                return apply_row_packed(x2, _as_linear(attn[name], i))

        x = x + attention_decode(
            lp["attn"], rms_norm(x, lp["norm1"]), cfg,
            {"k": cache["k"][i], "v": cache["v"][i], "pos": cache["pos"]}, wmm=wmm,
        )
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
    cache["pos"].add_(token.shape[1])
    return logits, cache
