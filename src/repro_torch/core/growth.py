"""Analytical growth-probability model (paper Section IV, Eq. 1-4, Fig. 6).

Truly unstructured sparsity == iid Bernoulli weights: each weight is non-zero
with probability ``p1`` and the count of non-zeros in a window of ``w``
columns is Binomial(w, p1).

A copy of the JAX package's ``core/growth.py`` (numpy only).
"""

from __future__ import annotations

from math import comb

import numpy as np

__all__ = [
    "p_row_gain",
    "p_grow",
    "growth_curves",
    "expected_width_distribution",
]


def p_row_gain(w: int, A: int, p1: float) -> float:
    """Eq. 1+3: P(#non-zeros in a w-wide row window <= A) = Binom CDF."""
    p1 = float(p1)
    return float(sum(comb(w, i) * p1**i * (1.0 - p1) ** (w - i) for i in range(0, min(A, w) + 1)))


def p_grow(N: int, w: int, A: int, p1: float) -> float:
    """Eq. 2+4: P(an N-row tile virtually grows to an N x w window)."""
    return p_row_gain(w, A, p1) ** N


def growth_curves(N: int, M: int, A: int, sparsity: np.ndarray) -> dict:
    """Fig. 6: P(grow to N x w) for each w in (A, M] over a sparsity sweep.

    ``sparsity`` is P0 = 1 - P1 (the paper's x-axis).  Returns
    ``{w: probabilities}`` for w = A+1 .. M (w = A has probability 1).
    """
    sparsity = np.asarray(sparsity, dtype=np.float64)
    out = {}
    for w in range(A + 1, M + 1):
        out[w] = np.array([p_grow(N, w, A, 1.0 - s) for s in sparsity])
    return out


def expected_width_distribution(N: int, M: int, A: int, p1: float) -> np.ndarray:
    """Stationary distribution over *achieved* window widths for the greedy
    scheduler under iid sparsity.

    ``dist[w]`` = probability the scheduler's next window has width ``w``.
    Greedy picks the widest feasible w in [A, M]:
      P(width = M)  = p_grow(N, M, A, p1)
      P(width = w)  = p_grow(N, w, ...) - P(already feasible at w+1)  is only
    an approximation (feasibility is not nested across *different* column
    sets), but for iid weights windows share the leading columns, and
    feasibility at width w+1 implies feasibility of its w-prefix, so nesting
    holds exactly for the greedy left-anchored scheduler (dropping the last
    column can only reduce per-row counts).
    """
    dist = np.zeros(M + 1)
    prev = 0.0  # P(feasible at any width > w)
    for w in range(M, A, -1):
        p = p_grow(N, w, A, p1)
        dist[w] = max(p - prev, 0.0)
        prev = max(prev, p)
    dist[A] = max(1.0 - prev, 0.0)
    return dist
