"""Launch plan of the fused SwiGLU MLP (B2/B4) in ``csrc/vusa_packed.cu``.

The kernel runs one thread block cluster of ``CLUSTER`` blocks per (ff
window, tile of ``BT`` batch rows).  Block r of a cluster takes the r-th
ordered slice of the K gate and up rows and the r-th ordered slice of the D
rows of the transposed ``w_down`` pack; slices are whole chunks of
``CHUNK`` packed rows.  The cluster adds its blocks' gate and up sums in
rank order, forms the window's ``silu(gate) * up`` on chip, and each block
writes its down rows' share of the window's (B, D) partial; a second launch
sums the T window partials in order (no float atomics).  The plan is
computed here from K and D alone and passed to the C entry point, which
refuses any other, so row b of an output never depends on the number of
rows.
"""

from __future__ import annotations

from typing import NamedTuple

from .row_plan import BT, CHUNK, PARTS

__all__ = ["CLUSTER", "CHUNK", "PARTS", "BT", "MlpPlan", "mlp_plan", "slice_rows", "cuda_launches"]

CLUSTER = 8  # blocks per cluster: the portable maximum on Hopper


class MlpPlan(NamedTuple):
    cluster: int  # blocks per cluster, one ordered slice each
    rows: int  # gate/up packed rows per slice
    down_rows: int  # down packed rows per slice


def slice_rows(n: int) -> int:
    """Rows per ordered slice when ``n`` packed rows are cut over CLUSTER
    blocks: ceil(n / CLUSTER) rounded up to whole CHUNKs, at least one
    chunk: 96 at n = 768, 128 at 1000, 384 at 3072."""
    per = -(-n // CLUSTER)
    return max(1, -(-per // CHUNK)) * CHUNK


def mlp_plan(k: int, d: int) -> MlpPlan:
    """The plan of a fused MLP with K = d_model gate/up rows and D output
    rows: (CLUSTER, slice_rows(K), slice_rows(D))."""
    return MlpPlan(cluster=CLUSTER, rows=slice_rows(k), down_rows=slice_rows(d))


def cuda_launches(p: MlpPlan, rows: int, d: int, t: int) -> int:
    """CUDA launches of one wrapper call: the cluster kernel and the
    ordered sum of its window partials; none for an empty output or when
    there is no window (the output is then zeroed by a memset)."""
    return 0 if rows == 0 or d == 0 or t == 0 else 2
