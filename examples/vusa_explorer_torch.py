"""VUSA design-space explorer, on the PyTorch port's copy of the paper
model: sweep (N, M, A) against a target sparsity and report PPA-efficiency
using the Table-I-calibrated component model + the Eq. 1-4 growth model —
the tool a hardware team would use to pick the virtual-growth factor for
their workload.  The model is numpy on the host: it runs on no device.

Run:  PYTHONPATH=src python examples/vusa_explorer_torch.py --sparsity 0.85
"""

import argparse

from repro_torch.core.growth import expected_width_distribution
from repro_torch.core.hwmodel import HwModel
from repro_torch.core.simulator import ws_cycles


def evaluate(n, m, a, p1, hw, b=64):
    """Expected throughput per area/power at weight density p1."""
    dist = expected_width_distribution(n, m, a, p1)
    # expected cycles per scheduled window, and columns covered per window
    exp_cycles = sum(dist[w] * ws_cycles(b, n, w) for w in range(a, m + 1))
    exp_cols = sum(dist[w] * w for w in range(a, m + 1))
    throughput = exp_cols / exp_cycles  # columns per cycle (per row-tile)
    area = hw.area_vusa(n, m, a)
    power = hw.power_vusa(n, m, a)
    return throughput, throughput / area, throughput / power


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sparsity", type=float, default=0.85)
    ap.add_argument("--n", type=int, default=3)
    args = ap.parse_args()
    p1 = 1.0 - args.sparsity
    hw = HwModel()

    print(f"design space at {args.sparsity:.0%} sparsity (N={args.n}):")
    print(f"{'M':>3} {'A':>3} {'M/A':>5} {'thpt':>8} {'thpt/area':>10} {'thpt/power':>11}")
    best = None
    for a in (2, 3, 4, 6, 8):
        for growth in (1, 2, 3, 4, 6, 8):
            m = a * growth
            if m > 32:
                continue
            t, ta, tp = evaluate(args.n, m, a, p1, hw)
            print(f"{m:3d} {a:3d} {growth:5d} {t:8.4f} {ta:10.4f} {tp:11.4f}")
            if best is None or ta > best[0]:
                best = (ta, m, a)
    print(f"\nbest perf/area: M={best[1]}, A={best[2]} "
          f"(virtual growth {best[1]//best[2]}x) at {args.sparsity:.0%} sparsity")
    # paper's pick
    t, ta, tp = evaluate(3, 6, 3, p1, hw)
    print(f"paper's (3,6,3): thpt/area {ta:.4f}, thpt/power {tp:.4f}")


if __name__ == "__main__":
    main()
