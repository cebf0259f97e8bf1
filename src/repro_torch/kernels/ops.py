"""Packed linear layers on top of the port's kernels.

Port of the JAX package's ``kernels/ops.py``:

* the block-VUSA layer and the dense baseline, the paper's A/B pair:
  ``PackedLinear``, ``pack_linear``, ``apply_packed`` (kernel ``vusa_spmm``)
  and ``matmul`` (kernel ``dense_matmul``);
* the row format: ``RowPackedLinear`` (float values, or int8/int4 values
  with per-(window, row) scales), the packers (``pack_linear_rows_nm`` for
  the N:M structured comparison arm), ``dequantize_linear_values`` and the
  appliers that reshape, slice ``[:c]`` and cast the fp32 kernel output
  back to the activation dtype;
* the tensor-parallel appliers: ``shard_linear_windows`` pads a pack's
  window axis for a ``model`` mesh axis, ``local_windows`` cuts a rank's
  windows, and ``apply_row_packed_sharded`` / ``apply_fused_mlp_sharded``
  run the unmodified single-device kernel on a rank's windows, then
  gather: the column slices (B1/B3), or the fused MLP's window partials,
  summed in window order by the kernel's own second launch (B2/B4).
  Both are bitwise the single-device call at any mesh size.

The reference's ``k_blk`` heuristic and autotune cache budgeted TPU VMEM;
the CUDA kernels have no such knob, so neither exists here.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from ..core.packing import (
    QUANT_DTYPES,
    RowPacked,
    nm_mask,
    pack_blocks,
    pack_rows,
    quantize_rows,
)
from ..dist.comm import all_gather, axis_index, axis_size
from .dense_matmul import dense_matmul
from .ref import dequantize_values, vusa_fused_mlp_ref, vusa_packed_ref, vusa_spmm_ref
from .vusa_packed import (
    vusa_fused_mlp_matmul, vusa_fused_mlp_partials, vusa_packed_matmul, vusa_window_sum,
)
from .vusa_spmm import vusa_spmm

__all__ = [
    "PackedLinear", "pack_linear", "apply_packed", "apply_packed_ref", "matmul",
    "RowPackedLinear", "pack_linear_rows", "pack_linear_rows_t", "pack_linear_rows_nm",
    "nm_slot_bound", "pack_linear_rows_many",
    "linear_from_pack",
    "dequantize_linear_values", "apply_row_packed", "apply_row_packed_ref", "apply_fused_mlp",
    "apply_fused_mlp_ref", "mesh_axis_size", "shard_linear_windows", "local_windows",
    "apply_row_packed_sharded", "apply_row_packed_sharded_many", "apply_fused_mlp_sharded",
]


# --------------------------------------------------------------------------
# Block-VUSA linear and the dense baseline
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PackedLinear:
    """Device-resident block-VUSA pack of a (k, c) weight: per output tile
    of ``Tn`` columns, jobs of ``A`` kept rows and their row indices."""

    values: torch.Tensor  # (T, J, A, Tn) fp32
    row_idx: torch.Tensor  # (T, J, A) int32
    k: int  # logical K (pre-padding)
    c: int  # logical C (pre-padding)
    k_padded: int = 0

    @property
    def compression(self) -> float:
        dense = self.k * self.c * self.values.element_size()
        packed = self.values.numel() * self.values.element_size() + self.row_idx.numel() * 4
        return packed / dense

    @property
    def virtual_growth(self) -> float:
        """Padded K rows per job row, the pack's ``BlockPacked.virtual_growth``
        (the M/A analogue)."""
        _, j, a, _ = self.values.shape
        return max(self.k_padded, self.k) / (j * a)


def pack_linear(
    w, m_blk: int = 32, a_blk: int = 8, tile_n: int = 128, device=None
) -> PackedLinear:
    """Block-pack a sparse (K, C) weight, K zero-padded to ``m_blk`` and C to
    ``tile_n``.  Values land as fp32, the kernel's value type (the
    reference's ``jnp.asarray`` also lands a float64 pack as fp32), on
    ``device``: by default the tensor's own device, ``cuda`` for an array."""
    host, _, dev, _ = _host(w)
    k, c = host.shape
    k_pad, c_pad = (-k) % m_blk, (-c) % tile_n
    if k_pad or c_pad:
        host = np.pad(host, ((0, k_pad), (0, c_pad)))
    bp = pack_blocks(host, m_blk=m_blk, a_blk=a_blk, tile_n=tile_n)
    device = device or dev or "cuda"
    return PackedLinear(
        values=torch.from_numpy(bp.values).to(device, torch.float32),
        row_idx=torch.from_numpy(bp.row_idx).to(device),
        k=k, c=c, k_padded=k + k_pad,
    )


def _packed_input(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """x (..., K) flattened to (B, K) and zero-padded to the pack's K."""
    xf = x.reshape(-1, x.shape[-1])
    if p.k_padded > p.k:  # the weight was K-padded at pack time
        xf = F.pad(xf, (0, p.k_padded - p.k))
    return xf.contiguous()


def apply_packed(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """y = x @ W for block-packed W.  x: (..., K) -> (..., C) in ``x.dtype``."""
    y = vusa_spmm(_packed_input(x, p), p.values, p.row_idx, p.c)
    return y.reshape(*x.shape[:-1], p.c)


def apply_packed_ref(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    y = vusa_spmm_ref(_packed_input(x, p), p.values, p.row_idx, p.c)
    return y.reshape(*x.shape[:-1], p.c)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense baseline (M, K) @ (K, N) -> (M, N) fp32.  Accepts the shapes
    the reference's ``ops.matmul`` accepts: ``bm`` is 128, 8 or 1, whichever
    first divides M, and N and K must be multiples of 128 or at most 128."""
    m = x.shape[0]
    bm = 128 if m % 128 == 0 else (8 if m % 8 == 0 else 1)
    return dense_matmul(x, w, bm=bm)


# --------------------------------------------------------------------------
# Row-wise VUSA linear
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RowPackedLinear:
    """Device-resident row-wise VUSA pack of a (k, c) weight.

    ``value_dtype="dense"`` keeps float values.  ``"int8"``/``"int4"`` carry
    raw quantized bytes (int4 two slots per byte) plus per-(window, row)
    fp32 ``scales``; ``dense_itemsize`` is the element size of the dense
    weight the pack replaces, the denominator of ``byte_ratio``."""

    values: torch.Tensor  # (T, K, J*A) float, or (T, K, Sb) int8 when quantized
    positions: torch.Tensor  # (T, K, J*A) int8, -1 = idle
    k: int
    c: int
    a: int
    m: int = 128  # window width (lanes)
    scales: torch.Tensor | None = None  # (T, K) fp32, quantized packs only
    value_dtype: str = "dense"
    dense_itemsize: int | None = None
    # > 1: these are one rank's contiguous windows of a pack padded to
    # ``shards`` times as many, split over a ``model`` mesh axis of that
    # size (``local_windows``); ``c`` stays the whole pack's
    shards: int = 1

    @property
    def slots(self) -> int:
        """Logical slot count: positions are never nibble-packed."""
        return self.positions.shape[2]

    @property
    def byte_ratio(self) -> float:
        t = self.values.shape[0]
        vb = self.values.element_size()
        dense = self.k * t * self.m * (self.dense_itemsize or vb)
        packed = self.values.numel() * vb + self.positions.numel()
        if self.scales is not None:
            packed += self.scales.numel() * self.scales.element_size()
        return packed / dense


def linear_from_pack(
    rp: RowPacked, dtype=None, device="cuda", value_dtype: str = "dense",
    dense_itemsize: int | None = None,
) -> RowPackedLinear:
    """Place a host :class:`RowPacked` on ``device``.  ``"dense"`` casts the
    values to ``dtype`` when given (a bf16 weight packed as fp32 casts back
    exactly); ``"int8"``/``"int4"`` quantize them (``quantize_rows``) and
    record ``dense_itemsize`` (default: the host values' own)."""
    positions = torch.from_numpy(rp.row_positions)
    if value_dtype == "dense":
        values = torch.from_numpy(rp.values)
        if dtype is not None:
            values = values.to(dtype)
        return RowPackedLinear(values=values.to(device), positions=positions.to(device),
                               k=rp.k, c=rp.c, a=rp.a, m=rp.m)
    if value_dtype not in QUANT_DTYPES:
        raise ValueError(
            f"value_dtype must be 'dense' or one of {QUANT_DTYPES}, got {value_dtype!r}"
        )
    q = quantize_rows(rp, value_dtype)
    return RowPackedLinear(
        values=torch.from_numpy(q.values).to(device),
        positions=torch.from_numpy(q.row_positions).to(device),
        k=q.k, c=q.c, a=q.a, m=q.m,
        scales=torch.from_numpy(q.scales).to(device),
        value_dtype=value_dtype,
        dense_itemsize=dense_itemsize or q.dense_itemsize,
    )


def _host(w):
    """(host array to pack, dtype to restore, device, dense element size) for
    a tensor or array.  Tensors pack as fp32 (numpy has no bf16) and keep
    their own element size; arrays pack as they are."""
    if isinstance(w, torch.Tensor):
        host = w.detach().to("cpu", torch.float32).numpy()
        return host, w.dtype, w.device, w.element_size()
    host = np.asarray(w)
    return host, None, None, host.dtype.itemsize


JOB_ENTRIES = 1 << 24  # matrix entries one host packing job takes, about


def _window_slices(k: int, c: int, m: int) -> list:
    """Column slices of whole m-lane windows, about JOB_ENTRIES entries
    each, covering a (K, C) matrix."""
    per = max(1, JOB_ENTRIES // max(k * m, 1)) * m
    return [slice(j, j + per) for j in range(0, max(c, 1), per)]


def _merge_windows(parts: list, c: int) -> RowPacked:
    """One pack from the packs of consecutive window slices: slots padded
    to the largest (idle: value 0, position -1), windows concatenated.
    ``pack_rows`` sizes the slots by the largest row count of any window,
    so this is its pack of the whole matrix, byte for byte."""
    s = max(p.values.shape[2] for p in parts)

    def pad(x, fill):
        return np.pad(x, ((0, 0), (0, 0), (0, s - x.shape[2])), constant_values=fill)

    return RowPacked(k=parts[0].k, c=c, m=parts[0].m, a=parts[0].a,
                     values=np.concatenate([pad(p.values, 0) for p in parts]),
                     row_positions=np.concatenate([pad(p.row_positions, -1) for p in parts]))


def pack_linear_rows_many(
    mats: list, m: int = 128, a: int = 16, dtype=None, device="cuda",
    value_dtype: str = "dense", dense_itemsize: int | None = None,
) -> list:
    """``pack_rows`` of each (K, C) host matrix in ``mats``, placed on
    ``device`` by ``linear_from_pack`` (``dtype``, ``value_dtype``,
    ``dense_itemsize`` as there).  The window slices of every matrix
    (``_window_slices``) pack in host threads at once, and the
    quantization and the copies to the device run one matrix a thread:
    numpy leaves the interpreter lock while it works, so a vocabulary-wide
    head or a deep stack packs on every core.  The packs are the
    single-threaded ``pack_rows``'s, byte for byte (``_merge_windows``)."""
    jobs = [(i, sl) for i, h in enumerate(mats) for sl in _window_slices(*h.shape, m)]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        parts = list(pool.map(
            lambda job: pack_rows(np.ascontiguousarray(mats[job[0]][:, job[1]]), m=m, a=a),
            jobs))
        merged = [_merge_windows([p for (i, _), p in zip(jobs, parts) if i == n], h.shape[1])
                  for n, h in enumerate(mats)]
        return list(pool.map(
            lambda rp: linear_from_pack(rp, dtype, device, value_dtype, dense_itemsize), merged))


def pack_linear_rows(
    w, m: int = 128, a: int = 16, device=None, value_dtype: str = "dense"
) -> RowPackedLinear:
    """Row-pack a (K, C) weight.  The pack lands on ``device``, by default
    the tensor's own device (``cuda`` for a numpy array)."""
    host, dtype, dev, size = _host(w)
    return pack_linear_rows_many([host], m, a, dtype, device or dev or "cuda", value_dtype,
                                 size)[0]


def pack_linear_rows_t(
    w, m: int = 128, a: int = 16, device=None, value_dtype: str = "dense"
) -> RowPackedLinear:
    """Row-pack ``w`` *transposed* — windows cover ``w``'s leading (reduction)
    dim, the operand layout ``vusa_fused_mlp_matmul`` wants for ``w_down``
    (``pack_rows_t``)."""
    host, dtype, dev, size = _host(w)
    return pack_linear_rows_many([host.T], m, a, dtype, device or dev or "cuda", value_dtype,
                                 size)[0]


def nm_slot_bound(n: int, block: int, m: int, a: int) -> int:
    """The slot axis of an N:M pack: ``n * ceil(m / block)`` values a row and
    window at most, rounded up to whole jobs of ``a`` slots."""
    bound = n * -(-m // block)
    return -(-bound // a) * a


def pack_linear_rows_nm(
    w, n: int = 2, block: int = 4, m: int = 128, a: int = 16, device=None,
    value_dtype: str = "dense",
) -> RowPackedLinear:
    """Prune a (K, C) weight to N:M structure (``core.packing.nm_mask``), then
    row-pack it: an ordinary :class:`RowPackedLinear`, so float values run
    through B1 and int8/int4 values through B3 with the same ``row_plan``.

    The slot axis is held to the structure's bound (``nm_slot_bound``):
    idle slots pad a sparser pack up to it, so the job count depends on
    (n, block, m, a) alone and never on the data.  A row that needs more
    raises: that happens only where the blocks do not tile the windows
    (``m`` not a multiple of ``block``, or the last C % block columns,
    which ``nm_mask`` keeps whole, in a window of full blocks)."""
    host, dtype, dev, size = _host(w)
    masked = np.where(nm_mask(host, n, block), host, 0)
    p = pack_linear_rows_many([masked], m, a, dtype, device or dev or "cuda", value_dtype,
                              size)[0]
    bound = nm_slot_bound(n, block, m, a)
    bound += bound % 2 if value_dtype == "int4" else 0  # two int4 slots a byte
    if p.slots > bound:
        raise ValueError(
            f"an {n}:{block} pack needs {p.slots} slots a row, above its bound {bound}: "
            f"the blocks do not tile the {m}-lane windows (m % block or the last "
            f"{host.shape[1] % block} columns)")
    pad = bound - p.slots
    if pad == 0:
        return p
    vpad = pad // 2 if value_dtype == "int4" else pad
    return dataclasses.replace(p, values=F.pad(p.values, (0, vpad)),
                               positions=F.pad(p.positions, (0, pad), value=-1))


def dequantize_linear_values(p: RowPackedLinear) -> torch.Tensor:
    """fp32 (T, K, S) value slots of any pack (int4 nibbles decoded with the
    kernels' arithmetic shifts)."""
    return dequantize_values(p.values, p.scales, p.value_dtype)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def apply_row_packed(x: torch.Tensor, p: RowPackedLinear) -> torch.Tensor:
    """y = x @ W for row-packed W.  x: (..., K) -> (..., C) in ``x.dtype``."""
    y = vusa_packed_matmul(_flat(x), p.values, p.positions, p.scales, m=p.m,
                           value_dtype=p.value_dtype)
    return y[:, : p.c].reshape(*x.shape[:-1], p.c).to(x.dtype)


def apply_row_packed_ref(x: torch.Tensor, p: RowPackedLinear) -> torch.Tensor:
    y = vusa_packed_ref(_flat(x), p.values, p.positions, p.scales, m=p.m,
                        value_dtype=p.value_dtype)
    return y[:, : p.c].reshape(*x.shape[:-1], p.c).to(x.dtype)


def _check_fused_packs(k: int, gate, up, down_t) -> None:
    if gate.k != k or up.k != k:
        raise ValueError(f"gate/up reduce over {gate.k}/{up.k}, x has {k}")
    if not gate.m == up.m == down_t.m:
        raise ValueError(f"window widths differ: {gate.m}, {up.m}, {down_t.m}")
    if not gate.c == up.c == down_t.c:  # all windowed over ff
        raise ValueError(f"ff widths differ: {gate.c}, {up.c}, {down_t.c}")
    if not gate.value_dtype == up.value_dtype == down_t.value_dtype:
        raise ValueError(
            f"value dtypes differ: {gate.value_dtype}, {up.value_dtype}, {down_t.value_dtype}"
        )


def _fused_operands(gate, up, down_t):
    return (gate.values, gate.positions, up.values, up.positions, down_t.values,
            down_t.positions, gate.scales, up.scales, down_t.scales)


def apply_fused_mlp(
    x: torch.Tensor, gate: RowPackedLinear, up: RowPackedLinear, down_t: RowPackedLinear
) -> torch.Tensor:
    """Whole SwiGLU MLP through the fused kernel.  ``gate``/``up`` row-pack
    (K, ff); ``down_t`` row-packs ``w_down`` transposed.  x: (..., K) ->
    (..., D) in ``x.dtype``, D = ``down_t.k``."""
    _check_fused_packs(x.shape[-1], gate, up, down_t)
    y = vusa_fused_mlp_matmul(_flat(x), *_fused_operands(gate, up, down_t), m=gate.m,
                              value_dtype=gate.value_dtype)
    return y.reshape(*x.shape[:-1], down_t.k).to(x.dtype)


def apply_fused_mlp_ref(
    x: torch.Tensor, gate: RowPackedLinear, up: RowPackedLinear, down_t: RowPackedLinear
) -> torch.Tensor:
    _check_fused_packs(x.shape[-1], gate, up, down_t)
    y = vusa_fused_mlp_ref(_flat(x), *_fused_operands(gate, up, down_t), m=gate.m,
                           value_dtype=gate.value_dtype)
    return y.reshape(*x.shape[:-1], down_t.k).to(x.dtype)


# --------------------------------------------------------------------------
# Tensor-parallel appliers: the window axis over the mesh's ``model`` axis
# --------------------------------------------------------------------------


def mesh_axis_size(mesh, axis_name: str = "model") -> int:
    """Size of a mesh axis; 1 for no mesh or an absent axis (the degenerate
    case)."""
    return axis_size(mesh, axis_name)


def shard_linear_windows(p: RowPackedLinear, n_shards: int) -> RowPackedLinear:
    """Pad the window axis to a multiple of ``n_shards`` with no-op windows
    (value 0, position -1): the device twin of ``core.packing.shard_windows``.
    ``k``/``c`` are unchanged: pad windows reconstruct zero tiles past the
    real column range.  Quantized packs pad their scales with 1.0, so the
    no-op windows dequantize to exact zeros and stay finite."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if p.shards != 1:
        raise ValueError("the pack is already one rank's windows")
    pad = (-p.values.shape[0]) % n_shards
    if pad == 0:
        return p
    scales = None if p.scales is None else F.pad(p.scales, (0, 0, 0, pad), value=1.0)
    return dataclasses.replace(
        p, values=F.pad(p.values, (0, 0, 0, 0, 0, pad)),
        positions=F.pad(p.positions, (0, 0, 0, 0, 0, pad), value=-1), scales=scales)


def local_windows(p: RowPackedLinear, mesh, axis_name: str = "model") -> RowPackedLinear:
    """This rank's contiguous windows of ``p`` (padded by
    ``shard_linear_windows``), copied to fresh memory, with ``shards`` set
    to the axis size; ``p`` itself when the axis has size 1."""
    n = mesh_axis_size(mesh, axis_name)
    if n == 1:
        return p
    p = shard_linear_windows(p, n)
    t = p.values.shape[0] // n
    r = axis_index(mesh, axis_name)

    def cut(a):
        return None if a is None else a[r * t:(r + 1) * t].contiguous()

    return dataclasses.replace(p, values=cut(p.values), positions=cut(p.positions),
                               scales=cut(p.scales), shards=n)


def _check_rank_pack(p: RowPackedLinear, axis_name: str, tp: int) -> None:
    """Refuse a pack that is not one rank's windows of a ``tp``-way split:
    the appliers never cut a whole pack per call."""
    if p.shards != tp:
        raise ValueError(
            f"the pack holds the windows of {p.shards} rank(s) but mesh axis {axis_name!r} "
            f"has {tp}: pass one rank's windows (ops.local_windows, serve.packed.shard_packed "
            f"or pack_lm_weights(shards={tp}, rank=...))")


def apply_row_packed_sharded(x: torch.Tensor, p: RowPackedLinear, mesh=None,
                             axis_name: str = "model") -> torch.Tensor:
    """``apply_row_packed`` with the window axis split over ``axis_name``.

    Windows tile the *output* columns, so each rank's kernel emits a
    contiguous (B, T_loc*m) column slice; an all-gather over the axis
    reassembles the whole width on every rank, then it is cut to ``c``.
    The kernel's plan comes from K alone (``row_plan``), so every column is
    bitwise the single-device call's.  ``p`` is this rank's windows
    (``local_windows``); a size-1 axis runs the plain applier."""
    tp = mesh_axis_size(mesh, axis_name)
    _check_rank_pack(p, axis_name, tp)
    if tp == 1:
        return apply_row_packed(x, p)
    y = vusa_packed_matmul(_flat(x), p.values, p.positions, p.scales, m=p.m,
                           value_dtype=p.value_dtype)
    y = all_gather(y, mesh, axis_name, dim=1)
    return y[:, : p.c].reshape(*x.shape[:-1], p.c).to(x.dtype)


def apply_row_packed_sharded_many(x: torch.Tensor, packs: list, mesh=None,
                                  axis_name: str = "model") -> list:
    """``apply_row_packed_sharded`` of each pack of ``packs`` on the same
    ``x`` with one all-gather for all: each rank's column slices are
    concatenated, gathered once and cut apart again, the same bits as one
    gather a pack (a step's q, k and v projections)."""
    tp = mesh_axis_size(mesh, axis_name)
    if tp == 1:
        return [apply_row_packed_sharded(x, p, mesh, axis_name) for p in packs]
    for p in packs:
        _check_rank_pack(p, axis_name, tp)
    xf = _flat(x)
    ys = [vusa_packed_matmul(xf, p.values, p.positions, p.scales, m=p.m,
                             value_dtype=p.value_dtype) for p in packs]
    widths = [y.shape[1] for y in ys]
    whole = all_gather(torch.cat(ys, dim=1), mesh, axis_name, dim=1)  # rank-major
    by_rank = whole.reshape(xf.shape[0], tp, sum(widths)).split(widths, dim=2)
    return [y.reshape(xf.shape[0], -1)[:, : p.c].reshape(*x.shape[:-1], p.c).to(x.dtype)
            for y, p in zip(by_rank, packs)]


def apply_fused_mlp_sharded(
    x: torch.Tensor, gate: RowPackedLinear, up: RowPackedLinear, down_t: RowPackedLinear,
    mesh=None, axis_name: str = "model",
) -> torch.Tensor:
    """``apply_fused_mlp`` with the ff-window axis split over ``axis_name``.

    All three packs window the same ff dim, so a rank owns a slab of ff.
    It runs the fused kernel's first launch on its windows
    (``vusa_fused_mlp_partials``): the (T_loc, B, D) window partials.  The
    partials of every rank are all-gathered in window order, and the
    kernel's own ordered sum (``vusa_window_sum``) adds all T, the pad
    windows last as exact zeros.  No partial (B, D) output is all-reduced,
    which would add in another order: the result is the single-device
    kernel's, bitwise.  The packs are this rank's windows (``local_windows``);
    a size-1 axis runs the plain fused applier."""
    tp = mesh_axis_size(mesh, axis_name)
    for q in (gate, up, down_t):
        _check_rank_pack(q, axis_name, tp)
    if tp == 1:
        return apply_fused_mlp(x, gate, up, down_t)
    _check_fused_packs(x.shape[-1], gate, up, down_t)
    parts = vusa_fused_mlp_partials(_flat(x), *_fused_operands(gate, up, down_t), m=gate.m,
                                    value_dtype=gate.value_dtype)
    y = vusa_window_sum(all_gather(parts, mesh, axis_name, dim=0))
    return y.reshape(*x.shape[:-1], down_t.k).to(x.dtype)
