"""Launch plan of the shared GEMM skeleton ``csrc/tile_gemm.cuh``.

The block-VUSA product (``vusa_spmm``) and the dense baseline
(``dense_matmul``) run on one skeleton: a grid of ``BM x BN`` output tiles,
each reducing its ``nk`` rows in stages of ``KS`` rows, and each reduction
cut into ``S`` ordered slices whose fp32 partials a second launch sums in
slice order (no float atomics).  The plan is computed here, on the host,
and passed to the C entry points, which refuse a tile or stage size other
than their own.  It depends on ``nk`` alone (the reduction length: K for
the dense product, J*A for the block product), never on the number of
rows, so row r of an output does not depend on the other rows.

With S > 1 the partials take ``S * rows * ncols * 4`` bytes, so the
wrappers run the rows in chunks (``row_chunks``) whose partials fit
``WORKSPACE_BYTES``: one launch pair per chunk, the same bits as one launch
over all rows.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = [
    "BM", "BN", "KS", "WHOLE_STAGES", "SLICE_STAGES", "WORKSPACE_BYTES", "Plan", "plan",
    "row_chunks", "workspace_bytes", "cuda_launches",
]

BM = 32  # output rows per block
BN = 64  # output columns per block
KS = 32  # reduction rows per shared-memory stage
WHOLE_STAGES = 8  # a reduction of at most this many stages is not split
SLICE_STAGES = 4  # a longer one is cut into slices of at most this many
WORKSPACE_BYTES = 64 * 2**20  # the most fp32 partials one launch writes


class Plan(NamedTuple):
    S: int  # ordered reduction slices
    BM: int  # output rows per block
    BN: int  # output columns per block
    KS: int  # reduction rows per stage


def plan(nk: int) -> Plan:
    """The plan for ``nk`` reduction rows: 32 x 64 tiles (64 columns, so a
    C = 64 GEMM computes no idle lane, and enough tiles for the small-B deep
    layers); S = 1 for at most WHOLE_STAGES stages, else the least number
    of slices of at most SLICE_STAGES stages each."""
    stages = -(-nk // KS)
    s = 1 if stages <= WHOLE_STAGES else -(-stages // SLICE_STAGES)
    return Plan(S=s, BM=BM, BN=BN, KS=KS)


def _rows_per_launch(p: Plan, rows: int, ncols: int) -> int:
    if p.S == 1 or ncols == 0:
        return rows
    return max(p.BM, WORKSPACE_BYTES // (p.S * ncols * 4) // p.BM * p.BM)


def row_chunks(p: Plan, rows: int, ncols: int) -> list[tuple[int, int]]:
    """``(first, end)`` rows of each launch: all rows at once when S = 1;
    else runs of whole BM-row blocks (at least one) whose partials fit
    WORKSPACE_BYTES."""
    step = _rows_per_launch(p, rows, ncols)
    return [(r, min(r + step, rows)) for r in range(0, rows, max(step, 1))]


def workspace_bytes(p: Plan, rows: int, ncols: int) -> int:
    """Bytes of the fp32 partials the wrapper allocates, reused by every
    chunk: S * (rows of the largest chunk) * ncols * 4, none when S = 1 (the
    tile kernel then writes the output itself)."""
    return 0 if p.S == 1 else p.S * min(rows, _rows_per_launch(p, rows, ncols)) * ncols * 4


def cuda_launches(p: Plan, rows: int, ncols: int) -> int:
    """CUDA launches of one wrapper call: per row chunk, the tile kernel and,
    with more than one slice, the ordered sum of the partials."""
    return len(row_chunks(p, rows, ncols)) * (1 if p.S == 1 else 2)
