"""Silicon PPA model calibrated to the paper's Table I (16-nm, 1 GHz).

The paper synthesizes standard ``3x3 .. 3x6`` arrays and a ``VUSA 3x6``
(N=3, M=6, A=3) and reports area/power normalized to the VUSA.  We cannot
re-synthesize offline, so we fit a *component* model

    area  = N*M_phys * a_mac  +  N*M * a_spe  +  N*A*(M-A) * a_mux
    power = p_base + N*M_phys * p_mac + N*M * p_spe + N*A*(M-A) * p_mux

(where a standard array has ``M_phys = M`` MACs, no extra SPEs beyond the
registers folded into ``a_mac``/``p_mac``, and no muxes) to the four standard
points and the VUSA point of Table I.  The standard points pin the per-PE
slope; the VUSA point pins the SPE/mux split, using the paper's observation
that the MAC (not the muxing) dominates timing/power as a prior.

All outputs are normalized to VUSA(3, 6, 3) = 1.0, exactly as Table I.

A copy of the JAX package's ``core/hwmodel.py``.
"""

from __future__ import annotations

import dataclasses


__all__ = ["HwModel", "TABLE1_PAPER", "table1"]

# Paper Table I (normalized to VUSA 3x6).
TABLE1_PAPER = {
    # design               #MACs  area   power
    "standard_3x3": (9, 0.69, 0.86),
    "standard_3x4": (12, 0.91, 1.15),
    "standard_3x5": (15, 1.14, 1.41),
    "standard_3x6": (18, 1.37, 1.68),
    "vusa_3x6": (9, 1.00, 1.00),
}


@dataclasses.dataclass(frozen=True)
class HwModel:
    """Component PPA model (units: fraction of VUSA-3x6 area/power)."""

    # Area components -------------------------------------------------------
    a_pe: float = 0.69 / 9  # full PE (MAC + pipeline regs) from standard fit
    a_spe_frac: float = 0.26  # fraction of a PE that is pipeline registers
    a_mux_pos: float = 0.0  # per (MAC x reachable-extra-SPE) mux area
    # Power components ------------------------------------------------------
    p_base: float = 0.04  # clock tree / control
    p_pe: float = 0.0911  # per-PE slope from the standard fit
    p_spe_frac: float = 0.11
    p_mux_pos: float = 0.0

    def __post_init__(self):
        # Calibrate mux terms so VUSA(3,6,3) lands exactly on 1.0 / 1.0.
        a_spe = self.a_pe * self.a_spe_frac
        a_mac = self.a_pe - a_spe
        amux = (1.0 - (9 * a_mac + 18 * a_spe)) / (3 * 3 * (6 - 3))
        object.__setattr__(self, "a_mux_pos", amux)
        p_spe = self.p_pe * self.p_spe_frac
        p_mac = self.p_pe - p_spe
        pmux = (1.0 - (self.p_base + 9 * p_mac + 18 * p_spe)) / (3 * 3 * (6 - 3))
        object.__setattr__(self, "p_mux_pos", pmux)

    # -- standard arrays ----------------------------------------------------
    def area_standard(self, N: int, M: int) -> float:
        return N * M * self.a_pe

    def power_standard(self, N: int, M: int) -> float:
        return self.p_base + N * M * self.p_pe

    # -- VUSA ---------------------------------------------------------------
    def area_vusa(self, N: int, M: int, A: int) -> float:
        a_spe = self.a_pe * self.a_spe_frac
        a_mac = self.a_pe - a_spe
        return N * A * a_mac + N * M * a_spe + N * A * (M - A) * self.a_mux_pos

    def power_vusa(self, N: int, M: int, A: int) -> float:
        p_spe = self.p_pe * self.p_spe_frac
        p_mac = self.p_pe - p_spe
        return (
            self.p_base
            + N * A * p_mac
            + N * M * p_spe
            + N * A * (M - A) * self.p_mux_pos
        )


def table1(model: HwModel | None = None) -> dict:
    """Reproduce Table I from the fitted component model."""
    m = model or HwModel()
    out = {}
    for M in (3, 4, 5, 6):
        out[f"standard_3x{M}"] = (3 * M, m.area_standard(3, M), m.power_standard(3, M))
    out["vusa_3x6"] = (9, m.area_vusa(3, 6, 3), m.power_vusa(3, 6, 3))
    return out
