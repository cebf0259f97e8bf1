"""Row-packed linear layers on top of the packed-matmul kernels.

Port of the row-format part of the JAX package's ``kernels/ops.py``:
``RowPackedLinear`` (dense values), the packers, and the appliers that
reshape, slice ``[:c]`` and cast the fp32 kernel output back to the
activation dtype.  The reference's ``k_blk`` heuristic and autotune cache
budgeted TPU VMEM; the CUDA kernels have no such knob, so neither exists
here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.packing import RowPacked, pack_rows, pack_rows_t
from .ref import vusa_fused_mlp_ref, vusa_packed_ref
from .vusa_packed import vusa_fused_mlp_matmul, vusa_packed_matmul

__all__ = [
    "RowPackedLinear", "pack_linear_rows", "pack_linear_rows_t", "linear_from_pack",
    "apply_row_packed", "apply_row_packed_ref", "apply_fused_mlp", "apply_fused_mlp_ref",
]


@dataclasses.dataclass
class RowPackedLinear:
    """Device-resident row-wise VUSA pack of a (k, c) weight."""

    values: torch.Tensor  # (T, K, J*A) float
    positions: torch.Tensor  # (T, K, J*A) int8, -1 = idle
    k: int
    c: int
    a: int
    m: int = 128  # window width (lanes)

    @property
    def slots(self) -> int:
        return self.positions.shape[2]


def linear_from_pack(rp: RowPacked, dtype=None, device="cuda") -> RowPackedLinear:
    """Place a host :class:`RowPacked` on ``device`` (values cast to ``dtype``
    when given; a bf16 weight packed as fp32 casts back exactly)."""
    values = torch.from_numpy(rp.values)
    if dtype is not None:
        values = values.to(dtype)
    return RowPackedLinear(
        values=values.to(device),
        positions=torch.from_numpy(rp.row_positions).to(device),
        k=rp.k, c=rp.c, a=rp.a, m=rp.m,
    )


def _host(w):
    """(host array to pack, dtype to restore, device) for a tensor or array.
    Tensors pack as fp32 (numpy has no bf16); arrays pack as they are."""
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32).numpy(), w.dtype, w.device
    return np.asarray(w), None, None


def pack_linear_rows(w, m: int = 128, a: int = 16, device=None) -> RowPackedLinear:
    """Row-pack a (K, C) weight.  The pack lands on ``device``, by default
    the tensor's own device (``cuda`` for a numpy array)."""
    host, dtype, dev = _host(w)
    return linear_from_pack(pack_rows(host, m=m, a=a), dtype, device or dev or "cuda")


def pack_linear_rows_t(w, m: int = 128, a: int = 16, device=None) -> RowPackedLinear:
    """Row-pack ``w`` *transposed* — windows cover ``w``'s leading (reduction)
    dim, the operand layout ``vusa_fused_mlp_matmul`` wants for ``w_down``."""
    host, dtype, dev = _host(w)
    return linear_from_pack(pack_rows_t(host, m=m, a=a), dtype, device or dev or "cuda")


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def apply_row_packed(x: torch.Tensor, p: RowPackedLinear) -> torch.Tensor:
    """y = x @ W for row-packed W.  x: (..., K) -> (..., C) in ``x.dtype``."""
    y = vusa_packed_matmul(_flat(x), p.values, p.positions, m=p.m)
    return y[:, : p.c].reshape(*x.shape[:-1], p.c).to(x.dtype)


def apply_row_packed_ref(x: torch.Tensor, p: RowPackedLinear) -> torch.Tensor:
    y = vusa_packed_ref(_flat(x), p.values, p.positions, m=p.m)
    return y[:, : p.c].reshape(*x.shape[:-1], p.c).to(x.dtype)


def _check_fused_packs(k: int, gate, up, down_t) -> None:
    if gate.k != k or up.k != k:
        raise ValueError(f"gate/up reduce over {gate.k}/{up.k}, x has {k}")
    if not gate.m == up.m == down_t.m:
        raise ValueError(f"window widths differ: {gate.m}, {up.m}, {down_t.m}")
    if not gate.c == up.c == down_t.c:  # all windowed over ff
        raise ValueError(f"ff widths differ: {gate.c}, {up.c}, {down_t.c}")


def apply_fused_mlp(
    x: torch.Tensor, gate: RowPackedLinear, up: RowPackedLinear, down_t: RowPackedLinear
) -> torch.Tensor:
    """Whole SwiGLU MLP through the fused kernel.  ``gate``/``up`` row-pack
    (K, ff); ``down_t`` row-packs ``w_down`` transposed.  x: (..., K) ->
    (..., D) in ``x.dtype``, D = ``down_t.k``."""
    _check_fused_packs(x.shape[-1], gate, up, down_t)
    y = vusa_fused_mlp_matmul(
        _flat(x), gate.values, gate.positions, up.values, up.positions,
        down_t.values, down_t.positions, m=gate.m,
    )
    return y.reshape(*x.shape[:-1], down_t.k).to(x.dtype)


def apply_fused_mlp_ref(
    x: torch.Tensor, gate: RowPackedLinear, up: RowPackedLinear, down_t: RowPackedLinear
) -> torch.Tensor:
    _check_fused_packs(x.shape[-1], gate, up, down_t)
    y = vusa_fused_mlp_ref(
        _flat(x), gate.values, gate.positions, up.values, up.positions,
        down_t.values, down_t.positions, m=gate.m,
    )
    return y.reshape(*x.shape[:-1], down_t.k).to(x.dtype)
