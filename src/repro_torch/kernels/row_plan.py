"""Launch plan of the row-packed matmul (B1/B3) in ``csrc/vusa_packed.cu``.

The kernel cuts the reduction over a pack's K rows into ordered slices of
``ROWS`` packed rows: one block per (window, slice, tile of ``BT`` batch
rows).  With one slice the block writes the output; with more, each slice
writes an fp32 partial and a second launch sums the partials in slice
order (no float atomics).  The plan is computed here from K alone and
passed to the C entry point, which refuses any other slice size or count,
so row b of an output never depends on the number of rows.

With more than one slice the partials take ``slices * rows * ncols * 4``
bytes, so the wrapper runs the rows in chunks (``row_chunks``) whose
partials fit ``WORKSPACE_BYTES``: one launch pair per chunk, the same bits
as one launch over all rows.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = [
    "ROWS", "CHUNK", "PARTS", "BT", "WORKSPACE_BYTES", "RowPlan", "row_plan", "row_chunks",
    "workspace_bytes", "cuda_launches",
]

ROWS = 64  # packed rows per slice
CHUNK = 32  # packed rows per shared-memory stage inside a slice
PARTS = 4  # sums per output in a slice, the p-th over the p-th CHUNK / PARTS rows of each chunk
BT = 8  # batch rows per block
WORKSPACE_BYTES = 64 * 2**20  # the most fp32 partials one launch writes


class RowPlan(NamedTuple):
    slices: int  # ordered reduction slices
    rows: int  # packed rows per slice


def row_plan(k: int) -> RowPlan:
    """One slice for K <= ROWS packed rows, else ceil(K / ROWS) slices of
    ROWS rows (the last one shorter): 12 at K = 768, 16 at K = 1000, 48 at
    K = 3072."""
    return RowPlan(slices=max(1, -(-k // ROWS)), rows=ROWS)


def _rows_per_launch(p: RowPlan, rows: int, ncols: int) -> int:
    if p.slices == 1:
        return rows
    return max(BT, WORKSPACE_BYTES // (p.slices * ncols * 4) // BT * BT)


def row_chunks(p: RowPlan, rows: int, ncols: int) -> list[tuple[int, int]]:
    """``(first, end)`` batch rows of each launch: all at once with one
    slice; else runs of whole BT-row tiles (at least one) whose partials fit
    WORKSPACE_BYTES; none for an empty output."""
    if ncols == 0:
        return []
    step = _rows_per_launch(p, rows, ncols)
    return [(r, min(r + step, rows)) for r in range(0, rows, max(step, 1))]


def workspace_bytes(p: RowPlan, rows: int, ncols: int) -> int:
    """Bytes of the fp32 partials the wrapper allocates, reused by every
    chunk: slices * (rows of the largest chunk) * ncols * 4, none with one
    slice (the kernel then writes the output itself) or no column."""
    if p.slices == 1 or ncols == 0:
        return 0
    return p.slices * min(rows, _rows_per_launch(p, rows, ncols)) * ncols * 4


def cuda_launches(p: RowPlan, rows: int, ncols: int) -> int:
    """CUDA launches of one wrapper call: per row chunk the sliced kernel
    and, with more than one slice, the ordered sum of the partials."""
    return len(row_chunks(p, rows, ncols)) * (1 if p.slices == 1 else 2)
