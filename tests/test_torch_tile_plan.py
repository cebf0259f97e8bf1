"""The launch plan of the B5/B6 tile skeleton and its split-precision TF32
products, on the CPU.

``kernels/tile_plan.py`` computes the plan (ordered reduction slices S, tile
BM x BN, stage KS) that the ``vusa_spmm`` and ``dense_matmul`` wrappers pass
to ``csrc/tile_gemm.cuh``.  The wrappers' CUDA path is driven here with a
recording stand-in for the kernel library (operands stay on the CPU and
nothing is launched), so the plan and the fp32 workspace they hand to C are
checked without a card: the same at B = 1 as at each paper GEMM's B, one
slice where the reduction fits in one, S * B * N * 4 workspace bytes, and
for many rows, row chunks whose partials fit ``WORKSPACE_BYTES``.

``ref.tf32_split`` / ``ref.matmul_3xtf32`` emulate the kernels' products
(hi = tf32(v), lo = tf32(v - hi), each cut toward zero with integer ops;
hi*hi + hi*lo + lo*hi): held within 1e-5 of the largest fp64 output on
ResNet-18's conv16 (K = 4608), where one TF32 pass is not, and giving NaN
and +-inf where fp32 gives them.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.workloads import mobilenetv1_gemms, resnet18_gemms
from repro_torch.kernels import dense_matmul as dense_mod
from repro_torch.kernels import ops, ref, tile_plan
from repro_torch.kernels import vusa_spmm as spmm_mod

MODELS = {"resnet18": resnet18_gemms, "mobilenetv1": mobilenetv1_gemms}


def _tile_pad(d):
    """``d`` padded to the reference ``dense_matmul``'s tile contract."""
    return d if d <= 128 or d % 128 == 0 else -(-d // 128) * 128


class _Recorder:
    """Stands in for a kernel library: records each call's plan, rows and
    x / out pointers, and the wrappers' workspace; launches nothing."""

    def __init__(self):
        self.calls = []  # (S, BM, BN, KS) per call
        self.rows = []  # (x pointer, out pointer, rows) per call
        self.workspace = []

    def _record(self, args):  # x, x_bf16, ..., out, part, rows, ..., S, BM, BN, KS, stream
        self.calls.append(tuple(args[-5:-1]))
        self.rows.append((args[0], args[4], args[6]))
        return 0

    def vusa_spmm(self, *args):
        return self._record(args)

    def dense_matmul(self, *args):
        return self._record(args)


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    empty = torch.empty

    def spy_empty(*shape, **kw):
        t = empty(*shape, **kw)
        if t.ndim == 1:  # the wrappers' workspace is their only 1-D allocation
            rec.workspace.append(t.numel() * t.element_size())
        return t

    for mod in (spmm_mod, dense_mod):
        monkeypatch.setattr(mod, "_lib", lambda: rec)
        monkeypatch.setattr(mod, "_on_cpu", lambda *t: False)
        monkeypatch.setattr(mod, "_stream", lambda device: 0)
    monkeypatch.setattr(torch, "empty", spy_empty)
    return rec


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("kernel", ["vusa_spmm", "dense_matmul"])
def test_plan_independent_of_rows(recorder, model, kernel):
    """For every paper GEMM the wrapper passes the same plan at B = 1 as at
    the GEMM's B, the plan of ``tile_plan.plan`` for its reduction length,
    and a workspace of S * B * N * 4 bytes (none when S = 1)."""
    for g in MODELS[model]():
        if kernel == "vusa_spmm":  # an 85 % pruned weight's block pack keeps every row
            nk, ncols = -(-g.K // 32) * 32, g.C
            values = torch.empty((-(-g.C // 128), nk // 8, 8, 128))
            row_idx = torch.empty(values.shape[:3], dtype=torch.int32)
        else:  # operands padded to the reference's tile contract, as chip_smoke.py pads them
            nk, ncols = _tile_pad(g.K), _tile_pad(g.C)
            w = torch.empty((nk, ncols))
        plans = []
        for b in (1, g.B):
            recorder.workspace.clear()
            recorder.calls.clear()
            x = torch.empty((b, nk))
            if kernel == "vusa_spmm":
                spmm_mod.vusa_spmm(x, values, row_idx, ncols)
            else:
                dense_mod.dense_matmul(x, w, 1, ncols, nk)
            assert len(recorder.calls) == 1  # no paper GEMM needs row chunks
            p = tile_plan.Plan(*recorder.calls[-1])
            assert recorder.workspace == [tile_plan.workspace_bytes(p, b, ncols)]
            assert recorder.workspace[0] == (0 if p.S == 1 else p.S * b * ncols * 4)
            plans.append(p)
        assert plans[0] == plans[1] == tile_plan.plan(nk), g.name


@pytest.mark.parametrize(
    "nk,slices",
    [(1, 1), (32, 1), (100, 1), (256, 1), (257, 3), (288, 3), (576, 5), (2304, 18),
     (4608, 36)],
)
def test_slices_follow_reduction_length(nk, slices):
    """S = 1 while the reduction has at most WHOLE_STAGES stages of KS rows
    (K <= 256); beyond, the least number of slices of at most SLICE_STAGES
    stages (128 rows).  32 x 64 tiles for every reduction length: no idle
    lanes at C = 64, and twice the tiles of 128-column ones for the wide
    small-B layers."""
    assert (tile_plan.WHOLE_STAGES, tile_plan.SLICE_STAGES) == (8, 4)
    p = tile_plan.plan(nk)
    assert p == tile_plan.Plan(S=slices, BM=32, BN=64, KS=32)
    assert tile_plan.cuda_launches(p, 49, 512) == (1 if slices == 1 else 2)
    assert tile_plan.workspace_bytes(p, 49, 512) == (0 if slices == 1 else slices * 49 * 512 * 4)


@pytest.mark.parametrize("kernel", ["vusa_spmm", "dense_matmul"])
@pytest.mark.parametrize("rows", [448, 1000, 1344])
def test_many_rows_run_in_chunks_that_bound_the_workspace(recorder, kernel, rows):
    """K = 4608 (S = 36) and 1024 columns: 147,456 bytes of partials a row,
    so 448 rows (14 blocks of 32) fill the 64 MiB workspace.  The wrapper
    passes C consecutive row chunks of at most 448 rows that cover the
    batch, with x and out offset to each chunk's first row, one plan, and
    one workspace of S * 448 * 1024 * 4 bytes or less; one counted launch,
    two CUDA launches per chunk."""
    k, n = 4608, 1024
    x = torch.empty((rows, k))
    if kernel == "vusa_spmm":
        values = torch.empty((n // 128, k // 8, 8, 128))
        row_idx = torch.empty(values.shape[:3], dtype=torch.int32)
        mod, call = spmm_mod, lambda: spmm_mod.vusa_spmm(x, values, row_idx, n)
        out_itemsize = x.element_size()
    else:
        w = torch.empty((k, n))
        mod, call = dense_mod, lambda: dense_mod.dense_matmul(x, w, 1, n, k)
        out_itemsize = 4
    mod.reset_launch_counts()
    out = call()
    p = tile_plan.plan(k)
    chunks = tile_plan.row_chunks(p, rows, n)
    assert p.S == 36 and [r1 - r0 for r0, r1 in chunks][:-1] == [448] * (len(chunks) - 1)
    assert chunks[0][0] == 0 and chunks[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert recorder.calls == [tuple(p)] * len(chunks)
    assert recorder.rows == [(x.data_ptr() + r0 * k * 4, out.data_ptr() + r0 * n * out_itemsize,
                              r1 - r0) for r0, r1 in chunks]
    assert recorder.workspace == [36 * min(rows, 448) * n * 4]
    assert recorder.workspace[0] <= tile_plan.WORKSPACE_BYTES
    assert tile_plan.cuda_launches(p, rows, n) == 2 * len(chunks) == 2 * -(-rows // 448)
    assert getattr(mod, kernel).launches == 1


@pytest.mark.parametrize("ncols", [0, 1, 63, 64, 100, 128, 130, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ncols_is_the_full_output_sliced(ncols, dtype):
    """``vusa_spmm(..., ncols=c)`` and ``vusa_spmm_ref(..., ncols=c)`` equal
    the full (B, T*128) output sliced to c, in x's dtype."""
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(100, 256)) * (rng.random((100, 256)) > 0.7)).astype(np.float32)
    p = ops.pack_linear(w, 32, 8, 128, device="cpu")
    x = torch.from_numpy(rng.normal(size=(5, p.k_padded)).astype(np.float32)).to(dtype)
    full = spmm_mod.vusa_spmm(x, p.values, p.row_idx)
    assert full.shape == (5, 256) and full.dtype == dtype
    for got in (spmm_mod.vusa_spmm(x, p.values, p.row_idx, ncols),
                ref.vusa_spmm_ref(x, p.values, p.row_idx, ncols)):
        assert got.shape == (5, ncols) and got.dtype == dtype
        assert torch.equal(got, full[:, :ncols])


def test_ncols_outside_the_tiles_raises():
    p = ops.pack_linear(np.eye(64, dtype=np.float32), 32, 8, 128, device="cpu")
    with pytest.raises(ValueError, match="ncols"):
        spmm_mod.vusa_spmm(torch.zeros(2, 64), p.values, p.row_idx, 129)


def test_3xtf32_emulation_holds_conv16():
    """hi*hi + hi*lo + lo*hi within 1e-5 of the largest fp64 output on
    ResNet-18's conv16 (B 49, K 4608, C 512, weights normal and pruned to
    85 % by magnitude, x normal, numpy seed 0); a single TF32 pass is not."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4608, 512))
    w = (w * (np.abs(w) > np.quantile(np.abs(w), 0.85))).astype(np.float32)
    x = rng.standard_normal((49, 4608), dtype=np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    exact = xt.double() @ wt.double()
    scale = float(exact.abs().max())
    err3 = float((ref.matmul_3xtf32(xt, wt) - exact).abs().max()) / scale
    one = ref.tf32_truncate(xt).double() @ ref.tf32_truncate(wt).double()
    err1 = float((one - exact).abs().max()) / scale
    assert err3 <= 1e-5, err3
    assert err1 > 1e-5, err1


@pytest.mark.parametrize("bad", [float("inf"), -float("inf"), float("nan")])
def test_3xtf32_emulation_keeps_the_nonfinite_pattern(bad):
    """A +-inf or NaN in x[:, 0] against weights that TF32 holds exactly
    (lo = 0: 0, 1, -0.5), inexact ones and zeros gives NaN, +inf and -inf
    at exactly the outputs where fp32 gives them: where hi*hi is +-inf the
    cross terms, which may hold inf * 0, are left out."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(16, 12)).astype(np.float32)
    w[0, :6] = [0.0, 1.0, -0.5, 0.0, 1.0, -0.5]
    w[3, 3:6] = 0.0
    x = rng.normal(size=(5, 16)).astype(np.float32)
    x[1:, 0] = bad
    x[2, 3] = -bad  # inf - inf in row 2 where w[3] is not 0
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got, want = ref.matmul_3xtf32(xt, wt), xt.double() @ wt.double()
    for pat in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(pat(got), pat(want)), pat.__name__
    fin = torch.isfinite(want)
    assert float((got[fin] - want[fin]).abs().max()) <= 1e-5 * float(want[fin].abs().max())


def test_split_of_nonfinite_values_has_zero_lo():
    """Where v is not finite hi keeps it and lo is 0, so a NaN reaches the
    outputs it reaches in fp32; the largest finite values stay finite."""
    v = torch.tensor([float("inf"), -float("inf"), float("nan"), 3.4028235e38, -3.4028235e38])
    hi, lo = ref.tf32_split(v)
    assert torch.equal(lo[:3], torch.zeros(3))
    assert torch.equal(hi[:2], v[:2]) and bool(torch.isnan(hi[2]))
    assert bool(torch.isfinite(hi[3:]).all()) and bool(torch.isfinite(lo[3:]).all())
    rel = (hi[3:].double() + lo[3:].double() - v[3:].double()) / v[3:].double()
    assert float(rel.abs().max()) < 2.0**-20


def test_tf32_split_truncates_and_keeps_20_bits():
    """10 mantissa bits cut toward zero; hi + lo is within 2**-20 of v."""
    ulp = 2.0**-10
    v = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp + ulp / 2, -(1 + ulp / 2), 1 + 3 * ulp / 4, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1.0, 1 + ulp, -1.0, 1.0, 0.0], dtype=torch.float32)
    assert torch.equal(ref.tf32_truncate(v), want)
    r = torch.from_numpy(np.random.default_rng(1).normal(size=4096).astype(np.float32))
    hi, lo = ref.tf32_split(r)
    assert torch.equal(ref.tf32_truncate(hi), hi) and torch.equal(ref.tf32_truncate(lo), lo)
    assert bool((hi.abs() <= r.abs()).all()) and bool((hi * r >= 0).all())
    assert float(((hi.double() + lo.double() - r.double()) / r.double()).abs().max()) < 2.0**-20
