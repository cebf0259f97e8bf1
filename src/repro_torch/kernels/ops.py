"""Packed linear layers on top of the port's kernels.

Port of the JAX package's ``kernels/ops.py``:

* the block-VUSA layer and the dense baseline, the paper's A/B pair:
  ``PackedLinear``, ``pack_linear``, ``apply_packed`` (kernel ``vusa_spmm``)
  and ``matmul`` (kernel ``dense_matmul``);
* the row format: ``RowPackedLinear`` (float values, or int8/int4 values
  with per-(window, row) scales), the packers, ``dequantize_linear_values``
  and the appliers that reshape, slice ``[:c]`` and cast the fp32 kernel
  output back to the activation dtype.

The reference's ``k_blk`` heuristic and autotune cache budgeted TPU VMEM;
the CUDA kernels have no such knob, so neither exists here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..core.packing import (
    QUANT_DTYPES,
    RowPacked,
    pack_blocks,
    pack_rows,
    pack_rows_t,
    quantize_rows,
)
from .dense_matmul import dense_matmul
from .ref import dequantize_values, vusa_fused_mlp_ref, vusa_packed_ref, vusa_spmm_ref
from .vusa_packed import vusa_fused_mlp_matmul, vusa_packed_matmul
from .vusa_spmm import vusa_spmm

__all__ = [
    "PackedLinear", "pack_linear", "apply_packed", "apply_packed_ref", "matmul",
    "RowPackedLinear", "pack_linear_rows", "pack_linear_rows_t", "linear_from_pack",
    "dequantize_linear_values", "apply_row_packed", "apply_row_packed_ref", "apply_fused_mlp",
    "apply_fused_mlp_ref",
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


def pack_linear_rows(
    w, m: int = 128, a: int = 16, device=None, value_dtype: str = "dense"
) -> RowPackedLinear:
    """Row-pack a (K, C) weight.  The pack lands on ``device``, by default
    the tensor's own device (``cuda`` for a numpy array)."""
    host, dtype, dev, size = _host(w)
    return linear_from_pack(pack_rows(host, m=m, a=a), dtype, device or dev or "cuda",
                            value_dtype, size)


def pack_linear_rows_t(
    w, m: int = 128, a: int = 16, device=None, value_dtype: str = "dense"
) -> RowPackedLinear:
    """Row-pack ``w`` *transposed* — windows cover ``w``'s leading (reduction)
    dim, the operand layout ``vusa_fused_mlp_matmul`` wants for ``w_down``."""
    host, dtype, dev, size = _host(w)
    return linear_from_pack(pack_rows_t(host, m=m, a=a), dtype, device or dev or "cuda",
                            value_dtype, size)


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
