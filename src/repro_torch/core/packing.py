"""VUSA pack formats, host-side numpy.

A copy of the JAX package's ``core/packing.py``, in its three formats:

* ``pack_exact`` — the paper's scalar-granularity format: per row tile, the
  greedy scheduler's jobs with per-row MAC<->SPE assignments (Section III);
* ``pack_blocks`` — the block format the ``vusa_spmm`` kernel consumes: the
  reduction dim is cut into windows of ``m_blk`` rows; per output tile of
  ``tile_n`` columns only rows holding a non-zero are kept, packed into jobs
  of ``a_blk`` rows plus an int32 row-index map;
* ``pack_rows`` — the row-wise format of the decode path (``RowPacked``,
  ``pack_rows_t``, ``validate_rows``, ``unpack_rows``), with its quantized
  variant (``QuantizedRowPacked``, ``quantize_rows``, ``dequantize_rows``,
  the int4 nibble codec) and the N:M structured pack (``nm_mask``,
  ``pack_rows_nm``), the paper's structured-sparsity comparison arm.

One change: ``pack_rows`` is vectorised.  The reference loops in Python over
every (window, row) pair, about 1.1 M iterations for the whole ``vusa_edge``
decode step; here one ``nonzero`` over the windowed matrix places every
slot.  The output is byte-identical: slots in ascending lane order,
``ceil(max row-nnz / a)`` jobs, idle slots value 0 and position -1.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .vusa import Job, mac_assignment, schedule_matrix

__all__ = [
    "ExactPacked", "pack_exact", "unpack_exact", "BlockPacked", "pack_blocks", "unpack_blocks",
    "RowPacked", "pack_rows", "pack_rows_t", "shard_windows", "unpack_rows",
    "validate_rows",
    "QUANT_DTYPES", "QMAX", "QuantizedRowPacked", "pack_nibbles", "unpack_nibbles",
    "quantize_rows", "dequantize_rows", "nm_mask", "pack_rows_nm",
]


# --------------------------------------------------------------------------
# Exact (scalar) VUSA format
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ExactPacked:
    """Scalar VUSA pack of a (K, C) matrix on an (N, M, A) array."""

    N: int
    M: int
    A: int
    rows: int
    cols: int
    # Per row-tile: list of (job, values (N, A), spe_positions (N, A) int, -1 = idle MAC)
    tiles: List[List[Tuple[Job, np.ndarray, np.ndarray]]]

    @property
    def n_jobs(self) -> int:
        return sum(len(t) for t in self.tiles)


def pack_exact(w: np.ndarray, N: int, M: int, A: int) -> ExactPacked:
    k, c = w.shape
    sched = schedule_matrix(w != 0, N, M, A)
    tiles = []
    for t, jobs in enumerate(sched.jobs):
        r0 = t * N
        rows = min(N, k - r0)
        packed_jobs = []
        for job in jobs:
            vals = np.zeros((N, A), dtype=w.dtype)
            pos = np.full((N, A), -1, dtype=np.int64)
            for r in range(rows):
                row = w[r0 + r, job.start : job.start + job.width]
                nz = np.flatnonzero(row)
                macs = mac_assignment(nz, M, A)
                assert macs is not None, "scheduler produced an infeasible window"
                for p, j in zip(nz, macs):
                    vals[r, j] = row[p]
                    pos[r, j] = p
            packed_jobs.append((job, vals, pos))
        tiles.append(packed_jobs)
    return ExactPacked(N=N, M=M, A=A, rows=k, cols=c, tiles=tiles)


def unpack_exact(p: ExactPacked) -> np.ndarray:
    w = np.zeros((p.rows, p.cols), dtype=p.tiles[0][0][1].dtype if p.tiles else np.float32)
    for t, jobs in enumerate(p.tiles):
        r0 = t * p.N
        for job, vals, pos in jobs:
            for r in range(min(p.N, p.rows - r0)):
                for j in range(p.A):
                    if pos[r, j] >= 0:
                        w[r0 + r, job.start + pos[r, j]] = vals[r, j]
    return w


# --------------------------------------------------------------------------
# Block VUSA format (the vusa_spmm kernel's operands)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class BlockPacked:
    """Block-VUSA pack of a (K, C) matrix.

    values : (n_tiles, n_jobs, a_blk, tile_n) — packed non-zero weight rows
    row_idx: (n_tiles, n_jobs, a_blk) int32   — absolute K index per packed
             row (padding rows point at 0 with zero values, so the gathered
             contribution is exactly zero)
    """

    k: int
    c: int
    m_blk: int
    a_blk: int
    tile_n: int
    values: np.ndarray
    row_idx: np.ndarray

    @property
    def n_tiles(self) -> int:
        return self.values.shape[0]

    @property
    def n_jobs(self) -> int:
        return self.values.shape[1]

    @property
    def compression(self) -> float:
        """Packed weight bytes / dense weight bytes (index bytes included)."""
        dense = self.k * self.c * self.values.dtype.itemsize
        packed = self.values.size * self.values.dtype.itemsize + self.row_idx.size * 4
        return packed / dense

    @property
    def virtual_growth(self) -> float:
        """Mean K-rows covered per physical a_blk-row job (the M/A analogue)."""
        return self.k * self.n_tiles / (self.n_jobs * self.a_blk * self.n_tiles)


def pack_blocks(w: np.ndarray, m_blk: int, a_blk: int, tile_n: int) -> BlockPacked:
    """Pack (K, C) sparse ``w``; K % m_blk == 0, C % tile_n == 0, m_blk % a_blk == 0.

    Jobs of a tile run windows ascending, then kept rows ascending within a
    window; a tile with fewer jobs than the most any tile needs is padded
    with jobs of rows at index 0 and value 0."""
    k, c = w.shape
    assert k % m_blk == 0 and c % tile_n == 0 and m_blk % a_blk == 0, (k, c, m_blk, a_blk, tile_n)
    n_tiles = c // tile_n
    n_win = k // m_blk

    # Per (tile, window): rows with any non-zero -> ceil(nnz_rows/a_blk) jobs.
    jobs_per_tile = np.zeros(n_tiles, dtype=np.int64)
    tile_jobs: List[List[Tuple[int, np.ndarray]]] = [[] for _ in range(n_tiles)]
    for t in range(n_tiles):
        for wi in range(n_win):
            blk = w[wi * m_blk : (wi + 1) * m_blk, t * tile_n : (t + 1) * tile_n]
            nz_rows = np.flatnonzero((blk != 0).any(axis=1)) + wi * m_blk
            if len(nz_rows) == 0:
                continue  # fully-zero window: no job at all (MAC gating)
            for j0 in range(0, len(nz_rows), a_blk):
                rows = nz_rows[j0 : j0 + a_blk]
                tile_jobs[t].append((wi, rows))
        jobs_per_tile[t] = len(tile_jobs[t])

    n_jobs = int(jobs_per_tile.max())
    values = np.zeros((n_tiles, n_jobs, a_blk, tile_n), dtype=w.dtype)
    row_idx = np.zeros((n_tiles, n_jobs, a_blk), dtype=np.int32)
    for t in range(n_tiles):
        for j, (wi, rows) in enumerate(tile_jobs[t]):
            if len(rows):
                values[t, j, : len(rows)] = w[rows, t * tile_n : (t + 1) * tile_n]
                row_idx[t, j, : len(rows)] = rows
    return BlockPacked(
        k=k, c=c, m_blk=m_blk, a_blk=a_blk, tile_n=tile_n, values=values, row_idx=row_idx
    )


def unpack_blocks(p: BlockPacked) -> np.ndarray:
    w = np.zeros((p.k, p.c), dtype=p.values.dtype)
    for t in range(p.n_tiles):
        for j in range(p.n_jobs):
            for a in range(p.a_blk):
                # padding rows have zero values; adding is safe and exact
                w[p.row_idx[t, j, a], t * p.tile_n : (t + 1) * p.tile_n] += p.values[t, j, a]
    return w


# --------------------------------------------------------------------------
# Row-wise VUSA format (the vusa_packed kernels' operands)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RowPacked:
    """Row-wise VUSA pack of a (K, C) matrix over windows of ``m`` lanes.

    values:    (T, K, J*A)       value slots (0 = idle)
    positions: (T, K, J*A) int8  lane index within window (-1 = idle)

    Job ``j`` slot block ``[j*A, (j+1)*A)`` is one pass of the physical
    N x A array over window ``t`` (paper Section III-C: overflow rows force
    extra passes; fully-dense still works at J = ceil(M/A)).
    """

    k: int
    c: int
    m: int
    a: int
    values: np.ndarray
    row_positions: np.ndarray

    @property
    def n_jobs(self) -> int:
        return self.values.shape[2] // self.a

    def byte_ratio(self, value_bytes: int = 2) -> float:
        """Packed / dense device-memory bytes (int8 positions)."""
        dense = self.k * self.c * value_bytes
        packed = self.values.shape[0] * self.k * self.values.shape[2] * (value_bytes + 1)
        return packed / dense


def pack_rows(w: np.ndarray, m: int = 128, a: int = 16) -> RowPacked:
    """Pack (K, C) into the row-wise VUSA format (C padded to m)."""
    w = np.asarray(w)
    k, c = w.shape
    c_pad = (-c) % m
    if c_pad:
        w = np.pad(w, ((0, 0), (0, c_pad)))
    t = w.shape[1] // m
    blk = w.reshape(k, t, m).transpose(1, 0, 2)  # (T, K, m): window t, row r
    nz = blk != 0
    # jobs needed per window = ceil(max row-nnz / a), at least one
    max_nnz = max(int(nz.sum(axis=2).max(initial=1)), 1)
    slots = -(-max_nnz // a) * a
    values = np.zeros((t, k, slots), dtype=w.dtype)
    positions = np.full((t, k, slots), -1, dtype=np.int8)
    # a nonzero's slot is its rank among its row's nonzeros; nonzero() walks
    # C order, so each row's slots fill in ascending lane order
    rank = np.cumsum(nz, axis=2, dtype=np.int32) - 1
    ti, ri, li = np.nonzero(nz)
    si = rank[ti, ri, li]
    values[ti, ri, si] = blk[ti, ri, li]
    positions[ti, ri, si] = li.astype(np.int8)
    return RowPacked(k=k, c=c, m=m, a=a, values=values, row_positions=positions)


def pack_rows_t(w: np.ndarray, m: int = 128, a: int = 16) -> RowPacked:
    """Row-pack ``w`` *transposed*: windows cover ``w``'s leading dim.

    For a down-projection ``w_down`` of shape (ff, d) the fused MLP kernel
    needs ff — ``w_down``'s *reduction* dim — to be the windowed lane dim,
    so ``pack_rows_t(w_down)`` packs the (d, ff) transpose; ``unpack_rows``
    of the result returns ``w.T``."""
    return pack_rows(np.ascontiguousarray(np.asarray(w).T), m=m, a=a)


def shard_windows(p: RowPacked, n_shards: int) -> RowPacked:
    """Pad the window axis so ``n_shards`` ranks of the mesh's ``model``
    axis can each hold a contiguous block of windows (sharded serving).

    Pad windows are exact no-op jobs, value 0 and position -1, so
    ``unpack_rows`` of the result is unchanged: window ``t`` still covers
    columns ``[t*m, (t+1)*m)`` and the pad windows reconstruct all-zero
    tiles past the real column range.  Shard ``s`` owns windows
    ``[s*T/n, (s+1)*T/n)``, a contiguous column slice of the output, so the
    shards' outputs reassemble by concatenation.  An ``n_shards`` that
    already divides the window count returns the pack unchanged."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    t = p.values.shape[0]
    pad = (-t) % n_shards
    if pad == 0:
        return p
    values = np.concatenate(
        [p.values, np.zeros((pad,) + p.values.shape[1:], p.values.dtype)]
    )
    positions = np.concatenate(
        [p.row_positions, np.full((pad,) + p.row_positions.shape[1:], -1, np.int8)]
    )
    return RowPacked(k=p.k, c=p.c, m=p.m, a=p.a, values=values, row_positions=positions)


def validate_rows(p: RowPacked) -> None:
    """Check a :class:`RowPacked`'s structural invariants; raise ``ValueError``
    naming the first violation.  A flipped position byte would scatter a
    value into the wrong lane — finite and wrong — so bounds, dtype and shape
    are checked before a pack is served."""
    v, q = np.asarray(p.values), np.asarray(p.row_positions)
    if v.shape != q.shape:
        raise ValueError(f"values shape {v.shape} != positions shape {q.shape}")
    if q.dtype != np.int8:
        raise ValueError(f"positions dtype must be int8, got {q.dtype}")
    if v.ndim != 3:
        raise ValueError(f"expected (T, K, S) pack, got shape {v.shape}")
    if p.m < 1 or p.a < 1 or p.m > 128:
        raise ValueError(f"window m={p.m} / slots a={p.a} out of range (int8 lanes)")
    t, k, slots = v.shape
    if k != p.k:
        raise ValueError(f"pack rows {k} != declared k={p.k}")
    if slots % p.a:
        raise ValueError(f"slot count {slots} not a multiple of a={p.a}")
    if t * p.m < p.c:
        raise ValueError(f"{t} windows of {p.m} lanes cover {t * p.m} < c={p.c} columns")
    # widen before comparing: m=128 does not fit int8
    q = q.astype(np.int32)
    bad = (q < -1) | (q >= p.m)
    if bad.any():
        i = tuple(int(x) for x in np.argwhere(bad)[0])
        raise ValueError(f"position {int(q[i])} at {i} outside [-1, {p.m}) — corrupt metadata")
    if not np.isfinite(v).all():
        i = tuple(int(x) for x in np.argwhere(~np.isfinite(v))[0])
        raise ValueError(f"non-finite packed value at {i}")


def unpack_rows(p: RowPacked) -> np.ndarray:
    """Dense (K, C) matrix of a pack; repeated lanes in a row sum, exactly
    as the kernels' one-hot reconstruction does."""
    t, k, slots = p.values.shape
    w = np.zeros((t, k, p.m + 1), dtype=p.values.dtype)  # lane m collects idle slots
    lanes = np.where(p.row_positions >= 0, p.row_positions.astype(np.int64), p.m)
    ti, ri = np.meshgrid(np.arange(t), np.arange(k), indexing="ij")
    for s in range(slots):  # slot order, as the reference; (t, r) unique per slot
        w[ti, ri, lanes[:, :, s]] += p.values[:, :, s]
    return w[:, :, : p.m].transpose(1, 0, 2).reshape(k, t * p.m)[:, : p.c]


# --------------------------------------------------------------------------
# Quantized row-wise pack: int8 / int4-nibble values + per-window fp32 scales
# --------------------------------------------------------------------------

QUANT_DTYPES = ("int8", "int4")
QMAX = {"int8": 127, "int4": 7}


@dataclasses.dataclass
class QuantizedRowPacked:
    """Row-wise VUSA pack with integer-quantized value slots.

    values:    (T, K, S) int8 for ``int8``; (T, K, S//2) int8 for ``int4``
               (two slots per byte: slot 2i in the low nibble, 2i+1 high)
    positions: (T, K, S) int8  lane index within window (-1 = idle), always
               one byte per slot whatever the value dtype
    scales:    (T, K) float32  per-(window, row) dequant scale; all-zero
               rows carry scale 1.0 so dequant stays finite
    dense_itemsize: bytes per element of the *original* dense matrix, the
               denominator of byte-ratio accounting
    """

    k: int
    c: int
    m: int
    a: int
    value_dtype: str
    values: np.ndarray
    row_positions: np.ndarray
    scales: np.ndarray
    dense_itemsize: int

    @property
    def slots(self) -> int:
        return self.row_positions.shape[2]

    @property
    def n_jobs(self) -> int:
        return self.slots // self.a


def pack_nibbles(q: np.ndarray) -> np.ndarray:
    """Pack int4-range int8 values (..., S) into (..., S//2) bytes, S even.
    Slot ``2i`` lands in the low nibble, ``2i+1`` in the high nibble."""
    if q.shape[-1] % 2:
        raise ValueError(f"slot count {q.shape[-1]} must be even to nibble-pack")
    u = q.astype(np.uint8)
    lo, hi = u[..., 0::2], u[..., 1::2]
    return (((hi & 0xF) << 4) | (lo & 0xF)).astype(np.int8)


def unpack_nibbles(b: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_nibbles`: (..., S//2) bytes -> (..., S) int8.
    ``(b << 4) >> 4`` sign-extends the low nibble, ``b >> 4`` the high one
    (int8 arithmetic shifts)."""
    b = b.astype(np.int8)
    lo = ((b << 4) >> 4).astype(np.int8)
    hi = (b >> 4).astype(np.int8)
    out = np.empty(b.shape[:-1] + (b.shape[-1] * 2,), dtype=np.int8)
    out[..., 0::2] = lo
    out[..., 1::2] = hi
    return out


def quantize_rows(p: RowPacked, value_dtype: str) -> QuantizedRowPacked:
    """Quantize a :class:`RowPacked`'s value slots to ``int8`` or ``int4``.

    Symmetric per-(window, row) scaling: scale = amax / qmax over the row's
    slots within the window, q = clip(round(v / scale)).  For ``int4`` the
    slot axis is first padded to even (value 0, position -1: an idle slot)
    and then nibble-packed two slots per byte."""
    if value_dtype not in QUANT_DTYPES:
        raise ValueError(f"value_dtype must be one of {QUANT_DTYPES}, got {value_dtype!r}")
    qmax = QMAX[value_dtype]
    vals = np.asarray(p.values, dtype=np.float32)
    positions = np.asarray(p.row_positions)
    amax = np.abs(vals).max(axis=2)
    scales = np.where(amax > 0, amax / qmax, 1.0).astype(np.float32)
    q = np.clip(np.rint(vals / scales[:, :, None]), -qmax, qmax).astype(np.int8)
    if value_dtype == "int4":
        if q.shape[2] % 2:
            q = np.pad(q, ((0, 0), (0, 0), (0, 1)))
            positions = np.pad(positions, ((0, 0), (0, 0), (0, 1)), constant_values=-1)
        q = pack_nibbles(q)
    return QuantizedRowPacked(
        k=p.k, c=p.c, m=p.m, a=p.a, value_dtype=value_dtype,
        values=q, row_positions=np.ascontiguousarray(positions),
        scales=scales, dense_itemsize=int(np.asarray(p.values).dtype.itemsize),
    )


def dequantize_rows(q: QuantizedRowPacked) -> RowPacked:
    """Expand a quantized pack back to a float32 :class:`RowPacked`: each
    value is ``q * scale`` in float32, the product the kernels rebuild."""
    raw = np.asarray(q.values)
    if q.value_dtype == "int4":
        raw = unpack_nibbles(raw)
    vals = raw.astype(np.float32) * np.asarray(q.scales, np.float32)[:, :, None]
    return RowPacked(
        k=q.k, c=q.c, m=q.m, a=q.a,
        values=vals, row_positions=np.asarray(q.row_positions),
    )


# --------------------------------------------------------------------------
# N:M structured pack (S2TA's density-bound blocks): the comparison arm
# --------------------------------------------------------------------------


def nm_mask(w: np.ndarray, n: int, block: int) -> np.ndarray:
    """Boolean keep-mask enforcing N:M structure along each row: in every
    block of ``block`` consecutive columns keep the ``n`` largest-magnitude
    entries (S2TA's density-bound block).  Columns past the last full block
    are kept as they are."""
    if not 1 <= n <= block:
        raise ValueError(f"need 1 <= n <= block, got n={n} block={block}")
    k, c = w.shape
    c_full = (c // block) * block
    mask = np.ones_like(w, dtype=bool)
    if c_full:
        blk = np.abs(w[:, :c_full]).reshape(k, c_full // block, block)
        # drop the block - n smallest magnitudes per block (argpartition, O(block))
        kth = np.argpartition(blk, block - n, axis=2)[:, :, : block - n]
        bm = np.ones_like(blk, dtype=bool)
        np.put_along_axis(bm, kth, False, axis=2)
        mask[:, :c_full] = bm.reshape(k, c_full)
    return mask


def pack_rows_nm(
    w: np.ndarray, n: int = 2, block: int = 4, m: int = 128, a: int = 16
) -> RowPacked:
    """Prune ``w`` to N:M structure, then row-pack it.  The result is an
    ordinary :class:`RowPacked` (the same kernels take it) whose rows hold
    at most ``n * ceil(m / block)`` values a window: its job count does not
    depend on the data, the property structured sparsity buys."""
    w = np.asarray(w)
    return pack_rows(np.where(nm_mask(w, n, block), w, 0), m=m, a=a)
