"""VUSA-packed decode path for the dense LM family.

Port of the JAX package's ``serve/packed.py``.
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
and the vocab-wide head through ``vusa_packed_matmul``.  The legacy
MLP-only pack, ``pack_lm_mlps`` (a flat ``{w_gate, w_up, w_down}`` dict,
``w_down`` in its dense orientation), runs the same step with three
``vusa_packed_matmul`` calls a layer and no fused kernel.

On a mesh, ``pack_lm_weights(shards=tp)`` pads every pack's window axis
to a multiple of the ``model`` axis size, ``shard_packed`` keeps a rank's
contiguous windows of each (values, positions and scales alike;
``pack_lm_weights(shards=tp, rank=r)`` packs those windows alone, for a
quarter of the host work at ``tp = 4``: the engine's way), and
``lm_decode_step_packed(mesh=...)`` routes every packed product through
the tensor-parallel appliers of ``kernels/ops.py``, bitwise the
single-device step.  Where the serving engine splits attention by heads
(``dist/tp.py``), ``pack_lm_weights(split_heads=True)`` packs a rank's
attention from its own heads instead: q, k and v from the windows that
cover its heads' columns (the same windows as the whole pack's, cut to
the heads after the kernel), ``wo`` from its heads' rows, whose partial
product the plan sums over ``model``; no collective runs inside the
attention.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.packing import dequantize_rows, pack_rows, pack_rows_t, quantize_rows, unpack_rows
from ..dist.sharding import local_shard, window_sharding
from ..kernels.ops import (
    RowPackedLinear, apply_fused_mlp, apply_fused_mlp_sharded, apply_row_packed,
    apply_row_packed_sharded, apply_row_packed_sharded_many, mesh_axis_size,
    pack_linear_rows_many, shard_linear_windows,
)
from ..models.families import (
    DENSE_LEAVES, _dense_layer, _embed_tokens, _head_logits, layer_cache,
)
from ..models.common import rms_norm
from ..models.layers import attention_decode

__all__ = [
    "pack_lm_weights", "pack_lm_mlps", "lm_decode_step_packed", "packed_byte_ratios", "validate_packed",
    "qdq_lm_params", "pack_fingerprint", "shard_packed",
]

ATTN_NAMES = ("wq", "wk", "wv", "wo")
QKV = ATTN_NAMES[:3]


# --------------------------------------------------------------------------
# packers
# --------------------------------------------------------------------------


def _entry(p: RowPackedLinear, values, positions, scales=None) -> Dict:
    out = {"values": values, "positions": positions, "k": p.k, "c": p.c, "m": p.m, "a": p.a}
    if p.shards > 1:
        out["shards"] = p.shards
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


def _rank_columns(h: np.ndarray, m: int, shards: int, rank: int) -> np.ndarray:
    """The columns of rank ``rank``'s windows of a (K, C) matrix whose
    window axis pads to a multiple of ``shards``: T/shards windows of m
    columns, zero past C (the pad windows)."""
    t = -(-h.shape[1] // m)
    per = -(-t // shards) * m
    cols = h[:, rank * per:(rank + 1) * per]
    return np.pad(cols, ((0, 0), (0, per - cols.shape[1])))


def _pack_mats(mats: list, m: int, a: int, w: torch.Tensor, value_dtype: str,
               shards: int = 1, rank: Optional[int] = None) -> list:
    """Row packs of the host matrices ``mats`` (``w`` gives the dtype, device
    and element size), each window axis padded to a multiple of
    ``shards``.  With ``rank``, only that rank's windows are packed, ``c``
    kept whole: the windows ``ops.local_windows`` would cut from the whole
    pack, with the same values and positions slot for slot (a window's
    rows pack from its own columns alone), only fewer idle slots at the
    end of a row, which no kernel reads."""
    args = (m, a, w.dtype, w.device, value_dtype, w.element_size())
    if rank is None or shards == 1:
        return [shard_linear_windows(q, shards) for q in pack_linear_rows_many(mats, *args)]
    packs = pack_linear_rows_many([_rank_columns(h, m, shards, rank) for h in mats], *args)
    return [dataclasses.replace(q, c=h.shape[1], shards=shards) for q, h in zip(packs, mats)]


def _stack_layers(ws: torch.Tensor, m: int, a: int, transposed: bool = False,
                  value_dtype: str = "dense", shards: int = 1,
                  rank: Optional[int] = None) -> Dict:
    """Pack every layer of a stacked (L, K, C) weight (packing (L, C, K)'s
    transposes with ``transposed``, as ``pack_rows_t``), each pack's window
    axis padded to a multiple of ``shards`` (only ``rank``'s windows when
    given, ``_pack_mats``), and stack the packs on its device."""
    host = ws.detach().to("cpu", torch.float32).numpy()  # one copy for all layers
    mats = [h.T if transposed else h for h in host]
    return _stack_packs(_pack_mats(mats, m, a, ws, value_dtype, shards, rank))


def _as_linear(entry: Dict, layer: Optional[int] = None) -> RowPackedLinear:
    """A pack entry (or layer ``layer`` of a stacked one) as a linear."""
    values, positions, scales = entry["values"], entry["positions"], entry.get("scales")
    if layer is not None:
        values, positions = values[layer], positions[layer]
        scales = None if scales is None else scales[layer]
    return RowPackedLinear(values=values, positions=positions,
                           k=entry["k"], c=entry["c"], a=entry["a"], m=entry["m"],
                           scales=scales, value_dtype=entry.get("value_dtype", "dense"),
                           dense_itemsize=entry.get("dense_itemsize"),
                           shards=entry.get("shards", 1))


def _head_columns(c: int, m: int, tp: int, rank: int) -> tuple:
    """(lo, hi, off): the columns ``[lo, hi)`` of the windows of m lanes
    that cover rank ``rank``'s ``c / tp`` head columns of a (K, c)
    projection (``lo`` a multiple of m, so they are the whole pack's
    windows), and the offset of its first head column in them."""
    w = c // tp
    lo = rank * w // m * m
    return lo, min(-(-(rank + 1) * w // m) * m, c), rank * w - lo


def _stack_head_split(ws: torch.Tensor, name: str, m: int, a: int, value_dtype: str,
                      tp: int, rank: int) -> Dict:
    """Rank ``rank``'s pack of the stacked attention projection ``name``
    when attention splits by heads over ``tp`` ranks: q/k/v the columns of
    ``_head_columns`` (entry ``cols``: the offset and width of the heads in
    the kernel's output), ``wo`` its heads' rows (entry ``partial``: its
    product is this rank's addend of the whole)."""
    w = _flat_attn(ws, name)
    if name == "wo":
        k = w.shape[1] // tp
        return dict(_stack_layers(w[:, rank * k:(rank + 1) * k], m, a, value_dtype=value_dtype),
                    partial=True)
    lo, hi, off = _head_columns(w.shape[2], m, tp, rank)
    entry = _stack_layers(w[:, :, lo:hi], m, a, value_dtype=value_dtype)
    return dict(entry, cols=(off, w.shape[2] // tp))


def _flat_attn(w: torch.Tensor, name: str) -> torch.Tensor:
    """An attention projection's stacked weight as (L, K, C): q/k/v
    (L, d, nh, hd) -> (L, d, nh*hd), wo (L, nh, hd, d) -> (L, nh*hd, d)."""
    if name == "wo":
        return w.reshape(w.shape[0], -1, w.shape[-1])
    return w.reshape(w.shape[0], w.shape[1], -1)


def pack_lm_mlps(cfg: ArchConfig, params, m: int = 128, a: int = 16) -> Dict:
    """Legacy MLP-only pack: a flat ``{"w_gate", "w_up", "w_down"}`` dict,
    ``w_down`` packed in its dense orientation, the operands of the
    three-call baseline (``lm_decode_step_packed`` runs every MLP through
    ``vusa_packed_matmul`` three times and no fused kernel)."""
    ffn = params["layers"]["ffn"]
    return {name: _stack_layers(ffn[name], m, a) for name in ("w_gate", "w_up", "w_down")}


def pack_lm_weights(
    cfg: ArchConfig,
    params,
    m: int = 128,
    a: int = 16,
    scope: str = "all",
    fused_mlp: bool = True,
    value_dtype: str = "dense",
    shards: int = 1,
    rank: Optional[int] = None,
    split_heads: bool = False,
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
    value slots with per-(window, row) fp32 scales.  ``shards`` pads each
    pack's window axis to a multiple (no-op windows) so it splits evenly
    over a ``model`` mesh axis of that size: place the packs with
    ``shard_packed``, or pack only the windows of model rank ``rank``
    (the packs ``shard_packed`` would leave, for 1 / ``shards`` of the
    host work).  ``split_heads`` (with ``rank``): the attention projections
    are rank ``rank``'s of attention split by heads over ``shards`` ranks
    (``_stack_head_split``), no window padding."""
    if cfg.family != "dense":
        raise ValueError("the packed decode path targets the dense family")
    if scope not in ("mlp", "all"):
        raise ValueError(f"scope must be 'mlp' or 'all', got {scope!r}")
    ffn = params["layers"]["ffn"]
    mlp: Dict = {
        name: _stack_layers(ffn[name], m, a, value_dtype=value_dtype, shards=shards, rank=rank)
        for name in ("w_gate", "w_up")
    }
    if fused_mlp:
        mlp["w_down_t"] = _stack_layers(ffn["w_down"], m, a, True, value_dtype, shards, rank)
    else:
        mlp["w_down"] = _stack_layers(ffn["w_down"], m, a, value_dtype=value_dtype,
                                      shards=shards, rank=rank)
    out: Dict = {"mlp": mlp, "attn": None, "head": None, "scope": scope, "fused_mlp": fused_mlp}
    if scope == "all":
        attn_p = params["layers"]["attn"]
        if split_heads:
            if rank is None:
                raise ValueError("split_heads packs one rank's heads: give its rank")
            out["attn"] = {name: _stack_head_split(attn_p[name], name, m, a, value_dtype,
                                                   shards, rank) for name in ATTN_NAMES}
        else:
            out["attn"] = {
                name: _stack_layers(_flat_attn(attn_p[name], name), m, a,
                                    value_dtype=value_dtype, shards=shards, rank=rank)
                for name in ATTN_NAMES
            }
        if not cfg.tie_embeddings:
            w = params["lm_head"]
            (p,) = _pack_mats([w.detach().to("cpu", torch.float32).numpy()], m, a, w,
                              value_dtype, shards, rank)
            out["head"] = _entry(p, p.values, p.positions, p.scales)
    validate_packed(out)  # pack-time guard: never hand out a malformed pack
    return out


def shard_packed(packed: Dict, mesh) -> Dict:
    """A rank's share of a ``pack_lm_weights(shards=tp)`` dict on a mesh:
    each entry's window axis (axis 1 of a layer stack, 0 of the head) cut
    to this rank's contiguous windows under
    ``dist.sharding.window_sharding``, values, positions and scales alike
    (metadata is never placed apart from the values it indexes), and
    ``shards`` recorded: the windows ``pack_lm_weights(shards=tp, rank=r)``
    packs alone, slot for slot (its rows may end in fewer idle slots,
    which no kernel reads).  A size-1 ``model`` axis returns the
    pack unchanged; an entry already split, or whose window count the
    axis does not divide (packed without ``shards=tp``), raises."""
    tp = mesh_axis_size(mesh, "model")
    if tp == 1:
        return packed

    def place(entry):
        q = entry["positions"]
        axis = q.ndim - 3
        if entry.get("shards", 1) != 1 or q.shape[axis] % tp:
            raise ValueError(f"shard_packed needs whole packs of pack_lm_weights(shards={tp}): "
                             f"{q.shape[axis]} windows, shards={entry.get('shards', 1)}")
        spec = window_sharding(mesh, q.shape[axis], q.ndim, axis=axis)
        out = dict(entry, shards=tp)
        for leaf in ("values", "positions", "scales"):
            if entry.get(leaf) is not None:
                out[leaf] = local_shard(entry[leaf], spec[: entry[leaf].ndim], mesh)
        return out

    out = dict(packed, mlp={k: place(e) for k, e in packed["mlp"].items()})
    if packed.get("attn"):
        out["attn"] = {k: place(e) for k, e in packed["attn"].items()}
    if packed.get("head") is not None:
        out["head"] = place(packed["head"])
    return out


def _flat_entries(packed: Dict) -> Dict[str, Dict]:
    """``{name: entry}`` of a structured ``pack_lm_weights`` dict or of the
    legacy flat ``pack_lm_mlps`` one."""
    if "mlp" not in packed:
        return dict(packed)
    flat: Dict[str, Dict] = dict(packed["mlp"])
    if packed.get("attn"):
        flat.update(packed["attn"])
    if packed.get("head") is not None:
        flat["lm_head"] = packed["head"]
    return flat


def _host_bytes(t: torch.Tensor) -> bytes:
    """A tensor's raw bytes in C order, read from the host."""
    return t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()


def pack_fingerprint(packed: Dict) -> int:
    """CRC32 over every entry's name, geometry and ``values`` /
    ``positions`` / ``scales`` bytes (the reference's ``pack_fingerprint``,
    the same fields in the same order): a cheap identity of a loaded pack.
    Hot swaps journal it, so the journal alone tells which pack served
    which tokens; two packs built from the same params at the same config
    fingerprint the same.  One host fetch per leaf; never on the decode
    path."""
    import zlib

    crc = 0
    flat = _flat_entries(packed)
    for name in sorted(flat):
        e = flat[name]
        crc = zlib.crc32(name.encode(), crc)
        geom = (int(e["m"]), int(e["a"]), int(e["k"]), int(e["c"]),
                e.get("value_dtype", "dense"))
        crc = zlib.crc32(repr(geom).encode(), crc)
        for leaf in ("values", "positions", "scales"):
            if e.get(leaf) is not None:
                crc = zlib.crc32(_host_bytes(e[leaf]), crc)
    return crc


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
        windows = q.shape[-3] * e.get("shards", 1)  # a rank holds 1 / shards of them
        if windows * m < c:
            raise ValueError(
                f"{name}: {windows} windows of {m} lanes cover {windows * m} < c={c} columns"
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


def lm_decode_step_packed(params, packed, token, cache, cfg, rowwise: bool = False,
                          mesh=None, x=None):
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
    single-token steps, as the reference does.

    ``rowwise`` (the scheduler's pool step) computes the norms, the attend
    and any dense product one batch row at a time, so row b is bitwise a
    B = 1 step on its own cache row; the packed kernels run on all rows at
    once (their row b does not depend on B).  The cache may then be
    paged.

    ``mesh`` routes every packed product through the tensor-parallel
    appliers (``apply_row_packed_sharded``, ``apply_fused_mlp_sharded``):
    each rank runs the kernels on its windows of the pack (``shard_packed``)
    and the products are gathered whole, bitwise the single-device step.
    A ``model`` axis of size 1 is the plain single-device step.

    Under the serving engine's tensor-parallel plan (``dist/tp.py``) the
    dense leaves are this rank's shards: a pack of ``split_heads`` runs the
    attend on the local heads (q, k and v from the windows over them, the
    ``wo`` partial summed by the plan), a dense attention or head is the
    plan's, and ``x``, the embedding rows, may come from the caller
    (``families.lm_decode_step``).

    ``packed`` may also be the legacy flat ``pack_lm_mlps`` dict: the MLP
    packed, everything else dense, every MLP three ``vusa_packed_matmul``
    calls."""
    if cfg.family != "dense":
        raise ValueError("the packed decode path targets the dense family")
    if "mlp" not in packed:  # the legacy flat layout
        packed = {"mlp": packed, "attn": None, "head": None, "fused_mlp": False}
    if token.shape[1] > 1 and not _full_pack(packed):
        logits = []
        for i in range(token.shape[1]):
            lg, cache = lm_decode_step_packed(params, packed, token[:, i : i + 1], cache, cfg,
                                              rowwise, mesh)
            logits.append(lg)
        return torch.cat(logits, dim=1), cache
    mlp, attn = packed["mlp"], packed["attn"]
    fused = packed.get("fused_mlp", "w_down_t" in mlp)
    sharded = mesh_axis_size(mesh, "model") > 1
    if not sharded:
        row, fused_mlp = apply_row_packed, apply_fused_mlp
    else:
        def row(x2, lin):
            return apply_row_packed_sharded(x2, lin, mesh)

        def fused_mlp(x2, g, u, d):
            return apply_fused_mlp_sharded(x2, g, u, d, mesh)

    if x is None:
        x = _embed_tokens(params, token, cfg)
    # the dense leaves a layer reads: the attention's when it is not packed
    dense = {"attn": DENSE_LEAVES["attn"] if attn is None else ("bq", "bk", "bv")}
    for i in range(cfg.n_layers):
        lp = _dense_layer(params, i, dense)
        wmm = None
        if attn is not None:
            qkv: Dict[str, torch.Tensor] = {}

            def wmm(name, x2, i=i, qkv=qkv):
                e = attn[name]
                if "cols" in e:  # this rank's heads, from windows of its own: no collective
                    off, w = e["cols"]
                    return apply_row_packed(x2, _as_linear(e, i))[..., off:off + w]
                if e.get("partial"):  # wo on its heads' rows: summed by the plan
                    return apply_row_packed(x2, _as_linear(e, i))
                if sharded and name in QKV:  # q, k and v of one x: one gather for the three
                    if not qkv:
                        lins = [_as_linear(attn[n], i) for n in QKV]
                        qkv.update(zip(QKV, apply_row_packed_sharded_many(x2, lins, mesh)))
                    return qkv.pop(name)
                return row(x2, _as_linear(attn[name], i))

        x = x + attention_decode(lp["attn"], rms_norm(x, lp["norm1"], rowwise=rowwise), cfg,
                                 layer_cache(cache, i), wmm=wmm, rowwise=rowwise)
        h = rms_norm(x, lp["norm2"], rowwise=rowwise)
        b, s, d = h.shape
        hf = h.reshape(b * s, d)
        if fused:
            y2 = fused_mlp(hf, _as_linear(mlp["w_gate"], i), _as_linear(mlp["w_up"], i),
                           _as_linear(mlp["w_down_t"], i))
        else:  # three calls: gate/up/down round-trip the (B, ff) hidden state
            gate = F.silu(row(hf, _as_linear(mlp["w_gate"], i)))
            up = row(hf, _as_linear(mlp["w_up"], i))
            y2 = row((gate * up).to(hf.dtype), _as_linear(mlp["w_down"], i))
        x = x + y2.reshape(b, s, d).to(x.dtype)
        del lp  # under a plan: its gathered leaves
    x = rms_norm(x, params["final_norm"], rowwise=rowwise)
    if packed.get("head") is not None:
        b, s, d = x.shape
        logits = row(x.reshape(b * s, d), _as_linear(packed["head"])).reshape(b, s, -1)
    else:
        logits = _head_logits(params, x, cfg, rowwise)
    cache["pos"].add_(token.shape[1])
    return logits, cache
