"""Cycle-accurate-analytical simulator for WS systolic arrays (SCALE-Sim-like)
and for the VUSA composite (paper Section V-C methodology).

SCALE-Sim's analytical weight-stationary model for one R x C_arr fold:

    fill   = R                 (weights trickle down row-by-row)
    stream = B                 (B input rows enter from the left)
    drain  = R + C_arr - 2     (last partial sum exits bottom-right)

    cycles_per_fold = 2R + C_arr + B - 2

A GEMM ``(B x K) @ (K x C)`` needs ``ceil(K/R) * ceil(C/C_arr)`` folds.

For VUSA, the folds over the output-column dimension are replaced by the
scheduler's jobs: a job of width ``w`` behaves like one fold of a standard
``N x w`` array (fill is still N — weights load per-row — and drain scales
with the *virtual* width ``w``):

    cycles_job(w) = 2N + w + B - 2

A copy of the JAX package's ``core/simulator.py`` (numpy only).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from .vusa import Schedule, schedule_matrix

__all__ = [
    "Gemm",
    "ws_cycles",
    "gemm_cycles_standard",
    "gemm_cycles_vusa",
    "model_cycles_standard",
    "model_cycles_vusa",
    "conv2d_gemm",
    "VusaRunStats",
]


@dataclasses.dataclass(frozen=True)
class Gemm:
    """One (B x K) @ (K x C) matmul job; ``macs`` = B*K*C."""

    B: int  # streamed dimension (output pixels / tokens)
    K: int  # reduction dimension (rows of the stationary weight tile)
    C: int  # output features   (columns of the stationary weight tile)
    name: str = ""

    @property
    def macs(self) -> int:
        return self.B * self.K * self.C

    @property
    def ops(self) -> int:
        return 2 * self.macs


def conv2d_gemm(
    out_h: int, out_w: int, in_ch: int, out_ch: int, kh: int, kw: int, name: str = "",
    groups: int = 1,
) -> List[Gemm]:
    """im2col lowering of a conv layer to GEMM(s).

    Depthwise/grouped convs lower to ``groups`` independent GEMMs with
    ``in_ch/groups`` reduction channels and ``out_ch/groups`` filters each.
    """
    if groups == 1:
        return [Gemm(B=out_h * out_w, K=in_ch * kh * kw, C=out_ch, name=name)]
    gic, goc = in_ch // groups, out_ch // groups
    return [
        Gemm(B=out_h * out_w, K=gic * kh * kw, C=goc, name=f"{name}.g{g}")
        for g in range(groups)
    ]


def ws_cycles(B: int, R: int, C_arr: int) -> int:
    """Cycles for one weight-stationary fold on an R x C_arr array."""
    return 2 * R + C_arr + B - 2


def gemm_cycles_standard(g: Gemm, R: int, C_arr: int) -> int:
    folds = math.ceil(g.K / R) * math.ceil(g.C / C_arr)
    return folds * ws_cycles(g.B, R, C_arr)


@dataclasses.dataclass
class VusaRunStats:
    """Aggregated VUSA execution statistics for a workload."""

    cycles: int = 0
    jobs: int = 0
    # columns of load covered per achieved window width (index = width)
    load_by_width: np.ndarray | None = None

    def load_split(self) -> np.ndarray:
        t = self.load_by_width.sum()
        return self.load_by_width / max(t, 1)


def gemm_cycles_vusa(
    g: Gemm, mask: np.ndarray, N: int, M: int, A: int
) -> Tuple[int, Schedule]:
    """Cycles to run one GEMM with weight mask ``mask`` (K x C bool) on VUSA."""
    assert mask.shape == (g.K, g.C), (mask.shape, (g.K, g.C))
    sched = schedule_matrix(mask, N, M, A)
    cycles = 0
    for tile in sched.jobs:
        for job in tile:
            cycles += ws_cycles(g.B, N, job.width)
    return cycles, sched


def model_cycles_standard(gemms: Iterable[Gemm], R: int, C_arr: int) -> int:
    return sum(gemm_cycles_standard(g, R, C_arr) for g in gemms)


def model_cycles_vusa(
    gemms: Sequence[Gemm],
    masks: Sequence[np.ndarray],
    N: int,
    M: int,
    A: int,
) -> VusaRunStats:
    stats = VusaRunStats(load_by_width=np.zeros(M + 1))
    for g, mask in zip(gemms, masks):
        cycles, sched = gemm_cycles_vusa(g, mask, N, M, A)
        stats.cycles += cycles
        stats.jobs += sched.n_jobs
        for tile in sched.jobs:
            for job in tile:
                stats.load_by_width[job.width] += job.width * g.B  # weight by work
    return stats
