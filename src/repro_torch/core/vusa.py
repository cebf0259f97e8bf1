"""VUSA window scheduler — the paper's core contribution (Section III).

A VUSA row has ``M`` SPEs (pipeline registers) but only ``A`` MAC units.
MAC ``j`` (``j in [0, A)``) can be multiplexed onto SPEs ``[j, j + M - A]``
(a one-directional shifter of ``M - A`` positions; Fig. 5 of the paper).

A column *window* of width ``w`` (``A <= w <= M``) is feasible for an
``N``-row weight tile iff every row has at most ``A`` non-zero weights inside
the window **and** an injective MAC->SPE assignment within shift range exists
for each row.  The scheduler walks the columns left to right, greedily taking
the widest feasible window (paper: "starting with an N x (M-1) window, then
N x (M-2), and so on down to N x A, at which the conditions are guaranteed").

Everything here is plain numpy — this is the *semantic* layer used by the
cycle simulator, the packing code and the tests.  The block variant that
the ``vusa_spmm`` kernel consumes lives in :mod:`repro_torch.core.packing`.

A copy of the JAX package's ``core/vusa.py``: the port imports nothing of
that package, and the tests hold the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

__all__ = [
    "mac_assignment",
    "row_feasible",
    "window_feasible",
    "schedule_row_tile",
    "schedule_matrix",
    "Job",
    "Schedule",
    "load_split",
    "virtual_speedup",
    "schedule_widths_fast",
]


def mac_assignment(positions: Sequence[int], M: int, A: int) -> Optional[np.ndarray]:
    """Assign MAC units to non-zero SPE positions of one row window.

    ``positions`` are the non-zero column offsets inside the window
    (``0 <= p < w <= M``).  MAC ``j`` may serve SPEs ``[j, j + M - A]``.
    Returns an int array ``macs`` with ``macs[i]`` = MAC index for
    ``positions[i]``, or ``None`` when no injective in-range assignment
    exists.  Greedy smallest-feasible-MAC on ascending positions is optimal
    for interval constraints of this staircase form.
    """
    if len(positions) > A:
        return None
    shift = M - A
    macs = np.empty(len(positions), dtype=np.int64)
    next_free = 0
    for i, p in enumerate(sorted(positions)):
        lo = max(next_free, p - shift)
        if lo > min(p, A - 1):
            return None
        macs[i] = lo
        next_free = lo + 1
    return macs


def row_feasible(row_mask: np.ndarray, M: int, A: int) -> bool:
    """True iff one row window (bool mask of width ``w <= M``) fits A MACs."""
    positions = np.flatnonzero(row_mask)
    return mac_assignment(positions, M, A) is not None


def window_feasible(mask: np.ndarray, M: int, A: int) -> bool:
    """True iff every row of an (N, w) bool window is feasible."""
    counts = mask.sum(axis=1)
    if (counts > A).any():
        return False
    # Per-row shifter feasibility.  For windows narrower than M the shifter
    # condition is weaker (positions < w <= M), so checking against M is exact.
    return all(row_feasible(mask[r], M, A) for r in np.flatnonzero(counts > 0))


@dataclasses.dataclass(frozen=True)
class Job:
    """One VUSA job: an ``N x width`` window starting at column ``start``."""

    start: int
    width: int


@dataclasses.dataclass
class Schedule:
    """Full schedule for a weight matrix on a (N, M, A) VUSA."""

    N: int
    M: int
    A: int
    rows: int
    cols: int
    # jobs[t] = list of Jobs for row-tile t (rows t*N:(t+1)*N)
    jobs: List[List[Job]]

    @property
    def n_jobs(self) -> int:
        return sum(len(j) for j in self.jobs)

    def widths(self) -> np.ndarray:
        return np.array([job.width for tile in self.jobs for job in tile], dtype=np.int64)


def schedule_row_tile(mask: np.ndarray, M: int, A: int) -> List[Job]:
    """Greedy widest-window partition of an (N, C) bool mask into jobs."""
    n, c = mask.shape
    jobs: List[Job] = []
    start = 0
    while start < c:
        w = min(M, c - start)
        while w > A and not window_feasible(mask[:, start : start + w], M, A):
            w -= 1
        jobs.append(Job(start, w))
        start += w
    return jobs


def schedule_matrix(mask: np.ndarray, N: int, M: int, A: int) -> Schedule:
    """Schedule a full (K, C) weight mask on an (N, M, A) VUSA.

    The matrix is split into row tiles of N (the physical array height); each
    tile is independently partitioned into column windows.
    """
    k, c = mask.shape
    jobs = []
    for t0 in range(0, k, N):
        jobs.append(schedule_row_tile(mask[t0 : t0 + N], M, A))
    return Schedule(N=N, M=M, A=A, rows=k, cols=c, jobs=jobs)


def load_split(schedule: Schedule) -> np.ndarray:
    """Fraction of the matrix *columns covered* per window width.

    Returns an array ``split`` of length ``M + 1`` with ``split[w]`` = fraction
    of total (row-tile, column) load processed by windows of width ``w``.
    This is the paper's "load split" column of Tables II/III.
    """
    split = np.zeros(schedule.M + 1)
    total = 0
    for tile in schedule.jobs:
        for job in tile:
            split[job.width] += job.width
            total += job.width
    return split / max(total, 1)


def virtual_speedup(schedule: Schedule) -> float:
    """Throughput gain vs. running the same matrix on a plain N x A array.

    A plain N x A array needs ``ceil(C / A)`` jobs per row tile; VUSA needs
    ``len(jobs)``.  (Job *duration* is width-independent to first order — the
    stream length dominates — so job count is the right ratio; the cycle-exact
    comparison lives in :mod:`repro_torch.core.simulator`.)
    """
    import math

    dense_jobs = math.ceil(schedule.cols / schedule.A) * len(schedule.jobs)
    return dense_jobs / max(schedule.n_jobs, 1)


def schedule_widths_fast(mask: np.ndarray, N: int, M: int, A: int):
    """Vectorised scheduler for large matrices: returns (width histogram,
    jobs per tile).  Uses the count-only feasibility condition — exact,
    because the shifter assignment is always feasible when every row has
    <= A non-zeros (property-tested in tests/test_vusa_core.py; staircase
    Hall condition)."""
    k, c = mask.shape
    hist = np.zeros(M + 1, dtype=np.int64)
    per_tile_jobs = []
    cs = np.zeros((k, c + 1), dtype=np.int32)
    np.cumsum(mask, axis=1, out=cs[:, 1:])
    for t0 in range(0, k, N):
        tile = cs[t0 : t0 + N]
        start = 0
        n_jobs = 0
        while start < c:
            w = min(M, c - start)
            base = tile[:, start]
            while w > A and int((tile[:, start + w] - base).max()) > A:
                w -= 1
            hist[w] += 1
            n_jobs += 1
            start += w
        per_tile_jobs.append(n_jobs)
    return hist, per_tile_jobs
