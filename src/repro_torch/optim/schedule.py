"""LR schedules: plain float functions of the step (host-side scalars).

Port of the JAX package's ``optim/schedule.py``.  The reference evaluates
them in fp32 on the device; here they are Python floats, which the update
rounds to fp32 where it multiplies by them.
"""

from __future__ import annotations

import math

__all__ = ["linear_warmup", "cosine_schedule"]


def linear_warmup(step: int, warmup: int, peak: float) -> float:
    return peak * min(1.0, (step + 1) / max(warmup, 1))


def cosine_schedule(step: int, warmup: int, total: int, peak: float,
                    floor: float = 0.1) -> float:
    if step < warmup:
        return linear_warmup(step, warmup, peak)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))
