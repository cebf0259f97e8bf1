"""Row-packed linear layers on top of the packed-matmul kernels.

Port of the row-format part of the JAX package's ``kernels/ops.py``:
``RowPackedLinear`` (float values, or int8/int4 values with per-(window,
row) scales), the packers, ``dequantize_linear_values`` and the appliers
that reshape, slice ``[:c]`` and cast the fp32 kernel output back to the
activation dtype.  The reference's ``k_blk`` heuristic and autotune cache
budgeted TPU VMEM; the CUDA kernels have no such knob, so neither exists
here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.packing import QUANT_DTYPES, RowPacked, pack_rows, pack_rows_t, quantize_rows
from .ref import dequantize_values, vusa_fused_mlp_ref, vusa_packed_ref
from .vusa_packed import vusa_fused_mlp_matmul, vusa_packed_matmul

__all__ = [
    "RowPackedLinear", "pack_linear_rows", "pack_linear_rows_t", "linear_from_pack",
    "dequantize_linear_values", "apply_row_packed", "apply_row_packed_ref", "apply_fused_mlp",
    "apply_fused_mlp_ref",
]


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
