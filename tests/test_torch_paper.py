"""Port vs reference: the numpy paper model.

``repro_torch.core`` carries copies of the reference's scheduler
(``vusa``), growth model, cycle simulator, area/power model and workloads;
on the same inputs every output must be *equal* to ``repro.core``'s (no
tolerance: both run the same numpy arithmetic in the same order).
"""

import dataclasses

import numpy as np
import pytest

from repro.core import growth as ref_growth
from repro.core import hwmodel as ref_hwmodel
from repro.core import simulator as ref_simulator
from repro.core import vusa as ref_vusa
from repro.core import workloads as ref_workloads
from repro_torch.core import growth, hwmodel, simulator, vusa, workloads

N, M, A = 3, 6, 3  # the paper's VUSA 3x6


def _mask(rng, k, c, sparsity):
    return rng.random((k, c)) >= sparsity


def _jobs(sched):
    return [[(j.start, j.width) for j in tile] for tile in sched.jobs]


def _pruned_masks(gemms, rate, seed=0):
    """The magnitude-pruning masks of ``benchmarks/run.py _prune_masks``."""
    rng = np.random.default_rng(seed)
    masks = []
    for g in gemms:
        w = rng.normal(size=(g.K, g.C))
        masks.append(np.abs(w) > np.quantile(np.abs(w), rate))
    return masks


def test_table1_equal():
    assert hwmodel.TABLE1_PAPER == ref_hwmodel.TABLE1_PAPER
    assert hwmodel.table1() == ref_hwmodel.table1()
    assert dataclasses.asdict(hwmodel.HwModel()) == dataclasses.asdict(ref_hwmodel.HwModel())
    m, r = hwmodel.HwModel(), ref_hwmodel.HwModel()
    for n_, m_, a_ in ((3, 6, 3), (4, 8, 4), (8, 16, 4)):
        assert m.area_vusa(n_, m_, a_) == r.area_vusa(n_, m_, a_)
        assert m.power_vusa(n_, m_, a_) == r.power_vusa(n_, m_, a_)
        assert m.area_standard(n_, m_) == r.area_standard(n_, m_)
        assert m.power_standard(n_, m_) == r.power_standard(n_, m_)


def test_growth_model_equal():
    sparsity = np.linspace(0.0, 1.0, 101)
    got, want = growth.growth_curves(N, M, A, sparsity), ref_growth.growth_curves(N, M, A, sparsity)
    assert got.keys() == want.keys()
    for w in got:
        np.testing.assert_array_equal(got[w], want[w])
    for p1 in (0.0, 0.05, 0.15, 0.25, 0.5, 1.0):
        np.testing.assert_array_equal(growth.expected_width_distribution(N, M, A, p1),
                                      ref_growth.expected_width_distribution(N, M, A, p1))
        assert growth.p_grow(N, 5, A, p1) == ref_growth.p_grow(N, 5, A, p1)
        assert growth.p_row_gain(7, A, p1) == ref_growth.p_row_gain(7, A, p1)


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.85, 0.99])
def test_scheduler_equal(sparsity):
    """``schedule_matrix`` jobs, load split and speedup, and the fast
    scheduler's width histogram, on a random mask."""
    rng = np.random.default_rng(int(sparsity * 100))
    mask = _mask(rng, 31, 200, sparsity)  # a ragged last row tile
    got, want = vusa.schedule_matrix(mask, N, M, A), ref_vusa.schedule_matrix(mask, N, M, A)
    assert _jobs(got) == _jobs(want)
    np.testing.assert_array_equal(got.widths(), want.widths())
    np.testing.assert_array_equal(vusa.load_split(got), ref_vusa.load_split(want))
    assert vusa.virtual_speedup(got) == ref_vusa.virtual_speedup(want)
    for n_, m_, a_ in ((N, M, A), (4, 8, 2)):
        hist, per_tile = vusa.schedule_widths_fast(mask, n_, m_, a_)
        ref_hist, ref_per_tile = ref_vusa.schedule_widths_fast(mask, n_, m_, a_)
        np.testing.assert_array_equal(hist, ref_hist)
        assert per_tile == ref_per_tile
    for r in range(0, 31, 5):
        for s0 in range(0, 194, 37):
            row = mask[r, s0 : s0 + M]
            pos = np.flatnonzero(row)
            got_macs, want_macs = vusa.mac_assignment(pos, M, A), ref_vusa.mac_assignment(pos, M, A)
            assert (got_macs is None) == (want_macs is None)
            if got_macs is not None:
                np.testing.assert_array_equal(got_macs, want_macs)
            assert vusa.row_feasible(row, M, A) == ref_vusa.row_feasible(row, M, A)
            win = mask[r : r + N, s0 : s0 + M]
            assert vusa.window_feasible(win, M, A) == ref_vusa.window_feasible(win, M, A)


def test_cycles_equal_on_first_resnet18_gemms():
    """Standard and VUSA cycles, schedules and load split on the first three
    ResNet-18 GEMMs with their 85 % pruning masks."""
    gemms = workloads.resnet18_gemms()[:3]
    ref_gemms = ref_workloads.resnet18_gemms()[:3]
    masks = _pruned_masks(gemms, 0.85)
    for g, rg, mask in zip(gemms, ref_gemms, masks):
        for r, c in ((3, 3), (3, 6), (32, 32), (128, 128)):
            assert simulator.gemm_cycles_standard(g, r, c) == \
                ref_simulator.gemm_cycles_standard(rg, r, c)
        cyc, sched = simulator.gemm_cycles_vusa(g, mask, N, M, A)
        ref_cyc, ref_sched = ref_simulator.gemm_cycles_vusa(rg, mask, N, M, A)
        assert cyc == ref_cyc
        assert _jobs(sched) == _jobs(ref_sched)
    assert simulator.model_cycles_standard(gemms, N, M) == \
        ref_simulator.model_cycles_standard(ref_gemms, N, M)
    got = simulator.model_cycles_vusa(gemms, masks, N, M, A)
    want = ref_simulator.model_cycles_vusa(ref_gemms, masks, N, M, A)
    assert (got.cycles, got.jobs) == (want.cycles, want.jobs)
    np.testing.assert_array_equal(got.load_by_width, want.load_by_width)
    np.testing.assert_array_equal(got.load_split(), want.load_split())
    assert simulator.ws_cycles(49, 3, 6) == ref_simulator.ws_cycles(49, 3, 6)


@pytest.mark.parametrize("name", ["resnet18_gemms", "mobilenetv1_gemms"])
def test_workloads_equal(name):
    got, want = getattr(workloads, name)(), getattr(ref_workloads, name)()
    assert len(got) == len(want) == {"resnet18_gemms": 21, "mobilenetv1_gemms": 28}[name]
    for g, r in zip(got, want):
        assert (g.B, g.K, g.C, g.name, g.macs, g.ops) == (r.B, r.K, r.C, r.name, r.macs, r.ops)
    grouped = simulator.conv2d_gemm(14, 14, 64, 128, 3, 3, name="g", groups=4)
    ref_grouped = ref_simulator.conv2d_gemm(14, 14, 64, 128, 3, 3, name="g", groups=4)
    assert [dataclasses.astuple(g) for g in grouped] == \
        [dataclasses.astuple(g) for g in ref_grouped]
