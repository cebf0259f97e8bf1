"""Plain PyTorch versions of the port's kernels.

Port of the JAX package's ``kernels/ref.py`` oracles: the dense baseline
(``dense_matmul_ref``), the block-VUSA product (``vusa_spmm_ref``) and the
row-wise VUSA products, with the quantized packs' dequant
(``dequantize_values``, the twin of the Pallas kernels' ``_dequant``)
applied first when scales are given.  The packed ones consume the *packed*
operands, so kernel-vs-plain equality checks the kernel and
unpack-vs-dense checks the packer.  ``tf32_split`` and ``matmul_3xtf32``
emulate the split-precision TF32 products of ``csrc/tile_gemm.cuh`` for
the tests, and ``vusa_packed_sliced_ref`` and ``vusa_fused_mlp_sliced_ref``
the orders of operations of the row-packed kernel and of the fused MLP
kernel in ``csrc/vusa_packed.cu``; no kernel wrapper uses them.
The wrappers in :mod:`repro_torch.kernels` run these for tensors on the
CPU (the two decode products one row and one window at a time, so that
row b does not depend on B there either, the kernels' contract, and a
window's columns not on the other windows, which a tensor-parallel rank
does not hold); ``chip_smoke.py`` holds the CUDA kernels against them on
the card.  The fused MLP is split as its kernel is: the window partials
(``vusa_fused_mlp_partials_ref``) and their sum in window order
(``window_sum_ref``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .mlp_plan import mlp_plan
from .row_plan import CHUNK, PARTS, ROWS

__all__ = [
    "dense_matmul_ref", "vusa_spmm_ref", "vusa_packed_ref", "vusa_fused_mlp_ref", "unpack_dense",
    "dequantize_values", "tf32_truncate", "tf32_split", "matmul_3xtf32", "vusa_packed_sliced_ref",
    "vusa_fused_mlp_sliced_ref", "vusa_fused_mlp_partials_ref", "window_sum_ref",
]

VALUE_DTYPES = ("dense", "int8", "int4")


def dense_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with both operands widened to fp32, fp32 out.

    The reference's oracle rounds its result to ``x.dtype``; its kernel,
    like the one here, returns fp32, so the plain version does too."""
    return x.float() @ w.float()


def vusa_spmm_ref(
    x: torch.Tensor, values: torch.Tensor, row_idx: torch.Tensor, ncols: int | None = None
) -> torch.Tensor:
    """Block-VUSA packed matmul.

    x: (B, K); values (T, J, A, Tn) packed weight rows per output tile;
    row_idx (T, J, A) absolute K index per packed row (padding rows point at
    0 with value 0).  Returns (B, ncols) in ``x.dtype``, contracted in fp32;
    ``ncols`` defaults to T * Tn."""
    t, j, a, tn = values.shape
    xg = x[:, row_idx.long()]  # (B, T, J, A): the SPE -> MAC shifter
    y = torch.einsum("btja,tjan->btn", xg.float(), values.float())
    return y.reshape(x.shape[0], t * tn)[:, :ncols].to(x.dtype)


def tf32_truncate(v: torch.Tensor) -> torch.Tensor:
    """fp32 cut to TF32 (10 mantissa bits) toward zero, as the tile kernels
    cut it: the low 13 bits of the fp32 pattern cleared with an integer op.
    Non-finite values are kept."""
    v = v.float()
    cut = torch.bitwise_and(v.view(torch.int32), ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(v), cut, v)


def tf32_split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(v) and lo = tf32(v - hi), both cut toward
    zero; lo = 0 where v (and so hi) is not finite."""
    v = v.float()
    hi = tf32_truncate(v)
    lo = tf32_truncate(v - hi)
    return hi, torch.where(torch.isfinite(v), lo, torch.zeros_like(lo))


def matmul_3xtf32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``hi_x @ hi_w + (hi_x @ lo_w + lo_x @ hi_w)`` in fp64: the value the
    tile kernels' split-precision products approximate (their fp32
    accumulation adds its own rounding).  As in their epilogue, where the
    ``hi_x @ hi_w`` sum is +-inf it stands alone: the cross terms may hold
    inf * 0 there."""
    xh, xl = (t.double() for t in tf32_split(x))
    wh, wl = (t.double() for t in tf32_split(w))
    hh = xh @ wh
    return torch.where(torch.isinf(hh), hh, xh @ wl + xl @ wh + hh)


def dequantize_values(
    raw: torch.Tensor, scales: torch.Tensor | None, value_dtype: str = "dense"
) -> torch.Tensor:
    """fp32 value slots (..., S) of a pack's raw values.

    ``dense`` widens float values.  ``int8`` and ``int4`` multiply each slot
    by its row's fp32 scale (``scales`` has the raw values' shape without
    the slot axis); ``int4`` first decodes two slots per byte, the low
    nibble as ``(b << 4) >> 4`` and the high as ``b >> 4`` on int8, slot
    2i low and 2i+1 high."""
    if value_dtype not in VALUE_DTYPES:
        raise ValueError(f"value_dtype must be one of {VALUE_DTYPES}, got {value_dtype!r}")
    if value_dtype == "dense":
        return raw.float()
    if value_dtype == "int4":
        lo = torch.bitwise_right_shift(torch.bitwise_left_shift(raw, 4), 4)
        hi = torch.bitwise_right_shift(raw, 4)
        raw = torch.stack([lo, hi], dim=-1).reshape(*raw.shape[:-1], 2 * raw.shape[-1])
    return raw.float() * scales.float()[..., None]


def unpack_dense(values: torch.Tensor, positions: torch.Tensor, m: int = 128) -> torch.Tensor:
    """Row-pack (T, K, S) -> dense (K, T*m) fp32.

    Slots add into their lanes (a repeated lane sums, as the reference's
    one-hot contraction does); idle slots (position -1) and lanes outside
    the window contribute nothing."""
    t, k, _ = values.shape
    p = positions.long()
    lanes = torch.where((p >= 0) & (p < m), p, m)  # lane m collects what no lane takes
    w = torch.zeros((t, k, m + 1), dtype=torch.float32, device=values.device)
    w.scatter_add_(2, lanes, values.float())
    return w[:, :, :m].permute(1, 0, 2).reshape(k, t * m)


def vusa_packed_ref(
    x: torch.Tensor,
    values: torch.Tensor,
    positions: torch.Tensor,
    scales: torch.Tensor | None = None,
    m: int = 128,
    value_dtype: str = "dense",
) -> torch.Tensor:
    """``y[b, t*m + l] = sum_k x[b, k] * sum_s values[t, k, s] * [positions[t, k, s] == l]``.

    x: (B, K); values/positions: (T, K, S) (int4 values (T, K, S/2));
    scales (T, K) for quantized values.  Returns (B, T*m) fp32.  Computed
    one row of x at a time (``_by_row``), so that row b does not depend on
    B, bitwise, as the CUDA kernel's does: the batched speculative verify
    relies on it.  Each window's (1, m) product is its own call on its own
    copy of the window's columns (``_windows``), so a column does not
    depend on which other windows the call holds either: a rank of a
    tensor-parallel mesh that holds some of the windows computes its
    columns bitwise as one device holding all of them."""
    ws = _windows(_dense(values, positions, scales, m, value_dtype), m)
    if not ws:
        return torch.zeros((x.shape[0], 0), dtype=torch.float32, device=x.device)
    return _by_row(x, lambda row: torch.cat([row @ w for w in ws], dim=1))


def _dense(values, positions, scales, m, value_dtype) -> torch.Tensor:
    """The dense fp32 (K, T*m) weight of a pack of any value kind."""
    return unpack_dense(dequantize_values(values, scales, value_dtype), positions, m)


def _windows(w: torch.Tensor, m: int) -> list:
    """The (K, m) column windows of a dense (K, T*m) weight, each copied to
    fresh memory."""
    return [c.contiguous() for c in w.split(m, dim=1)]


def _by_row(x: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` over fp32 ``x`` (B, K) one row at a time, each row copied to
    fresh memory: row b of the result does not depend on B, bitwise.  A CPU
    GEMM's order of operations changes with the row count (and may with
    the alignment of its operand), so ``x @ w`` alone is not row-stable."""
    xf = x.float()
    if xf.shape[0] == 0:
        return fn(xf)
    return torch.cat([fn(row.clone()) for row in xf.split(1)])


def vusa_fused_mlp_partials_ref(
    x: torch.Tensor,
    gate_values: torch.Tensor,
    gate_positions: torch.Tensor,
    up_values: torch.Tensor,
    up_positions: torch.Tensor,
    down_values: torch.Tensor,
    down_positions: torch.Tensor,
    gate_scales: torch.Tensor | None = None,
    up_scales: torch.Tensor | None = None,
    down_scales: torch.Tensor | None = None,
    m: int = 128,
    value_dtype: str = "dense",
) -> torch.Tensor:
    """The (T, B, D) fp32 window partials of the SwiGLU MLP over
    row-packed operands: partial t is ``silu(x @ Wg_t) * (x @ Wu_t) @
    Wd_t`` over window t's m ff lanes alone.  ``gate``/``up`` pack (K, ff);
    ``down`` packs ``w_down`` *transposed* (D, ff), so the ff reduction dim
    is the windowed one.  Quantized packs carry scales (T, K) for gate/up
    and (T, D) for down.  One row of x and one window at a time, each
    product its own call on its own copy of the window: row b of window t
    depends on neither B nor the other windows, bitwise."""
    wg = _windows(_dense(gate_values, gate_positions, gate_scales, m, value_dtype), m)
    wu = _windows(_dense(up_values, up_positions, up_scales, m, value_dtype), m)
    wd = [w.T.contiguous() for w in _windows(
        _dense(down_values, down_positions, down_scales, m, value_dtype), m)]  # (m, D) each
    t, d = down_positions.shape[:2]
    if x.shape[0] == 0 or t == 0:
        return torch.zeros((t, x.shape[0], d), dtype=torch.float32, device=x.device)
    rows = [row.clone() for row in x.float().split(1)]
    return torch.stack([torch.cat([(F.silu(r @ g) * (r @ u)) @ dn for r in rows])
                        for g, u, dn in zip(wg, wu, wd)])


def window_sum_ref(parts: torch.Tensor) -> torch.Tensor:
    """``parts[0] + parts[1] + ... + parts[T-1]`` over the leading axis, in
    that order, in fp32: the fused MLP's second launch.  Zero partials
    (the pad windows of a sharded pack) change no bit.  (0, ...) sums to
    zeros."""
    if parts.shape[0] == 0:
        return torch.zeros(parts.shape[1:], dtype=torch.float32, device=parts.device)
    out = parts[0].float()
    for p in parts[1:]:
        out = out + p
    return out


def vusa_fused_mlp_ref(
    x: torch.Tensor,
    gate_values: torch.Tensor,
    gate_positions: torch.Tensor,
    up_values: torch.Tensor,
    up_positions: torch.Tensor,
    down_values: torch.Tensor,
    down_positions: torch.Tensor,
    gate_scales: torch.Tensor | None = None,
    up_scales: torch.Tensor | None = None,
    down_scales: torch.Tensor | None = None,
    m: int = 128,
    value_dtype: str = "dense",
) -> torch.Tensor:
    """``silu(x @ Wg) * (x @ Wu) @ Wd`` over row-packed operands: the
    window partials (``vusa_fused_mlp_partials_ref``) added in window order
    (``window_sum_ref``), the kernel's two launches.  Returns (B, D) fp32;
    row b does not depend on B, bitwise."""
    return window_sum_ref(vusa_fused_mlp_partials_ref(
        x, gate_values, gate_positions, up_values, up_positions, down_values, down_positions,
        gate_scales, up_scales, down_scales, m, value_dtype))


def _slice_sums(x: torch.Tensor, w: torch.Tensor, rows: int, slices: int) -> list[torch.Tensor]:
    """The fp32 sums of x @ w over ``slices`` ordered slices of ``rows``
    packed rows of the dense (K, N) weight w (a slice past K sums to zero),
    in the kernels' order: each slice walked in chunks of ``CHUNK`` rows;
    per output, ``PARTS`` sums, the p-th over the p-th ``CHUNK / PARTS`` rows
    of every chunk, each in ascending k, added in order at the slice's end.
    Each step is one fp32 rounding of an fp64 product and sum (the kernel's
    fmaf, but for a rare double rounding)."""
    w, xd = w.double(), x.double()
    per = CHUNK // PARTS
    out = []
    for k0 in range(0, slices * rows, rows):
        acc = [torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
               for _ in range(PARTS)]
        for kk in range(k0, min(k0 + rows, w.shape[0])):
            h = (kk - k0) % CHUNK // per
            acc[h] = (acc[h].double() + xd[:, kk, None] * w[kk]).float()
        part = acc[0]
        for a in acc[1:]:
            part = part + a
        out.append(part)
    return out


def _sum_in_order(parts: list[torch.Tensor]) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def vusa_packed_sliced_ref(
    x: torch.Tensor,
    values: torch.Tensor,
    positions: torch.Tensor,
    scales: torch.Tensor | None = None,
    m: int = 128,
    value_dtype: str = "dense",
) -> torch.Tensor:
    """``vusa_packed_ref`` in the order of operations of the row-packed
    CUDA kernel, whose geometry ``row_plan`` holds: the K packed rows cut
    into ordered slices of ``ROWS``, each summed as ``_slice_sums`` says,
    then the slices summed in order.  Every operation is elementwise over
    the batch, so row b of the result does not depend on B, bitwise.
    Returns (B, T*m) fp32."""
    w = unpack_dense(dequantize_values(values, scales, value_dtype), positions, m)
    k = w.shape[0]
    return _sum_in_order(_slice_sums(x, w, ROWS, max(1, -(-k // ROWS))))


def vusa_fused_mlp_sliced_ref(
    x: torch.Tensor,
    gate_values: torch.Tensor,
    gate_positions: torch.Tensor,
    up_values: torch.Tensor,
    up_positions: torch.Tensor,
    down_values: torch.Tensor,
    down_positions: torch.Tensor,
    gate_scales: torch.Tensor | None = None,
    up_scales: torch.Tensor | None = None,
    down_scales: torch.Tensor | None = None,
    m: int = 128,
    value_dtype: str = "dense",
) -> torch.Tensor:
    """``vusa_fused_mlp_ref`` in the order of operations of the fused MLP
    CUDA kernel, whose geometry ``mlp_plan`` holds.  gate and up: the K
    packed rows cut into the plan's ``cluster`` ordered slices of ``rows``,
    each summed as ``_slice_sums`` says, the slices added in rank order;
    h = g / (1 + exp(-g)) * u in fp32, one rounding a step; down: per
    window, output row and batch row, the row's slots in slot order, each
    occupied slot (position in [0, m)) adding v * h[position] with one fp32
    rounding of the fp64 product and sum (the kernel's fmaf); idle slots and
    positions outside the window are skipped, their values never used; then
    the window partials added in window order.  Every operation is
    elementwise over the batch, so row b of the result does not depend on
    B, bitwise.  Returns (B, D) fp32."""
    t, d = down_positions.shape[:2]
    plan = mlp_plan(x.shape[1], d)

    def gate_up(values, positions, scales):
        w = unpack_dense(dequantize_values(values, scales, value_dtype), positions, m)
        return _sum_in_order(_slice_sums(x, w, plan.rows, plan.cluster))  # (B, T*m)

    g = gate_up(gate_values, gate_positions, gate_scales)
    u = gate_up(up_values, up_positions, up_scales)
    h = (g / (1.0 + torch.exp(-g)) * u).double()
    vd = dequantize_values(down_values, down_scales, value_dtype).double()  # (T, D, S)
    pos = down_positions.long()
    parts = []
    for w in range(t):
        acc = torch.zeros((x.shape[0], d), dtype=torch.float32, device=x.device)
        for s in range(pos.shape[2]):
            q = pos[w, :, s]
            live = (q >= 0) & (q < m)
            hq = h[:, w * m + q.clamp(0, m - 1)]  # (B, D)
            step = (acc.double() + torch.where(live, vd[w, :, s], 0.0) * hq).float()
            acc = torch.where(live, step, acc)
        parts.append(acc)
    if not parts:
        return torch.zeros((x.shape[0], d), dtype=torch.float32, device=x.device)
    return _sum_in_order(parts)
