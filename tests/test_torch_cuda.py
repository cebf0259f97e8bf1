"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: skips without a CUDA device (the decision is taken inside
the test).  The file imports nothing of JAX, so it also runs on a machine
that has only the port:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Tolerance: 1e-4 of the largest output for fp32 and bf16 activations alike
(bf16 widens to fp32 exactly; both sides accumulate in fp32; int8/int4
values dequantize to the same fp32 products ``q * scale`` on both sides).
Row 0 of a B = 4 call must equal a B = 1 call bitwise.  B5/B6 also run
the shapes that split the reduction and take 64-column tiles (ResNet-18's
layer4, layer3 and layer1 GEMMs and its fully connected layer): two calls
are bitwise equal, rows of a sub-batch equal the same rows of the whole
batch bitwise, a NaN, +inf or -inf in x[:, 0] gives NaN, +inf and -inf at
exactly the outputs where the plain version gives them, and a batch whose
partials exceed the workspace runs in row chunks with the same bits, and
each library counts its own CUDA launches.  B1/B3 (the row-packed matmul,
all four value kinds, fp32 and bf16 x) run K = 768, 1000 and 3072 with 3
and 48 slots per row (4 for int4, whose slots pair in bytes), packs with
repeated lanes, lanes past m and NaN in idle slots, at B = 1, 4 and 9:
within 1e-4 of the plain version, row 0 bitwise equal to B = 1, and the
CUDA launches the library counts per call equal to ``row_plan``'s.  B2/B4
(the fused MLP, all four value kinds) run random packs of three different
slot counts (odd ones included) with repeated lanes, lanes past m and NaN
in idle slots, K and D off the slice size, at B = 1, 4 and 9 (two batch
tiles): within 1e-4 of the plain version, row 0 bitwise equal to B = 1,
CUDA launches as ``mlp_plan`` counts them, and within a stated number of
ulps of ``ref.vusa_fused_mlp_sliced_ref``.  The block-VUSA kernel returns
``x.dtype``: with bf16 ``x`` both sides round their fp32 sum to bf16 once,
so they may part by one bf16 step (2**-7 of the value) on top of the 1e-4.

The engine's CUDA-graph loop and speculative decoding run ``vusa_edge`` at
full width cut to 2 layers (numpy-seeded init, 85 % pruning, or the tier
structure of ``tests/test_spec_decode.py`` for the drafter), dense and
packed with fp32, int8 and int4 values: the graph loop's tokens equal the
eager loop's bitwise, greedy and sampled; speculative tokens equal plain
decode's bitwise; the full pack's batched verify equals sequential steps
bitwise (the kernels' and the glue's row stability at 5 rows); and one
eager decode step and one verify make no host sync
(``torch.cuda.set_sync_debug_mode("error")``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import dense_matmul as dense_mod
from repro_torch.kernels import mlp_plan, ref, row_plan, tile_plan
from repro_torch.kernels import vusa_packed as packed_mod
from repro_torch.kernels import vusa_spmm as spmm_mod
from repro_torch.kernels.dense_matmul import dense_matmul
from repro_torch.kernels.ops import (
    apply_fused_mlp,
    apply_fused_mlp_ref,
    apply_packed,
    apply_packed_ref,
    apply_row_packed,
    apply_row_packed_ref,
    matmul,
    pack_linear,
    pack_linear_rows,
    pack_linear_rows_t,
)
from repro_torch.kernels.vusa_packed import vusa_packed_matmul
from repro_torch.kernels.vusa_spmm import vusa_spmm
from repro_torch.configs import get_config
from repro_torch.core.pruning import prune_tree
from repro_torch.models import build_model
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.packed import lm_decode_step_packed


def _sparse(rng, k, c, sparsity):
    w = rng.normal(size=(k, c)) * (rng.random((k, c)) >= sparsity)
    return w.astype(np.float32)


def _close(got, want, tol=1e-4):
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * max(float(want.float().abs().max()), 1.0), err


def _close_rounded(got, want):
    """1e-4 of the largest output plus one rounding step of ``got.dtype``."""
    step = 2.0**-7 if got.dtype == torch.bfloat16 else 0.0
    err = (got.float() - want.float()).abs()
    tol = 1e-4 * max(float(want.float().abs().max()), 1.0) + step * want.float().abs()
    assert bool((err <= tol).all()), float(err.max())


def _same_nonfinite(got, want):
    for pat in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(pat(got), pat(want)), pat.__name__


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,k,c,sp,m_blk,a_blk",
    [
        (8, 256, 384, 0.9, 32, 8),
        (4, 100, 130, 0.85, 32, 8),
        (16, 512, 256, 0.0, 32, 8),
        (2, 64, 128, 0.99, 16, 8),
        (1, 147, 64, 0.85, 32, 8),
        (8450, 576, 200, 0.85, 32, 8),  # many row blocks, a ragged last one
        (49, 4608, 512, 0.85, 32, 8),  # ResNet-18 layer4: 18 ordered slices
        (196, 2304, 256, 0.85, 32, 8),  # layer3: 9 slices
        (3136, 576, 64, 0.85, 32, 8),  # layer1: 64-column tiles, 3 slices
        (1, 512, 1000, 0.85, 32, 8),  # the fully connected layer
    ],
)
def test_vusa_spmm_matches_plain_on_card(b, k, c, sp, m_blk, a_blk):
    """B5 vs its plain version: the shapes of tests/test_kernels.py, B = 1,
    C % 128 != 0, an all-zero window, many row blocks, split reductions and
    64-column tiles; fp32 and bf16 x; two calls bitwise equal; rows
    independent of B; a NaN in x[:, 0] reaches the same outputs as in the
    plain version (padding rows point at row 0 and are multiplied)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    w = _sparse(rng, k, c, sp)
    w[:m_blk, :] = 0.0  # the first window of every tile holds no job
    p = pack_linear(w, m_blk, a_blk, 128, device=dev)
    x = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32)).to(dev)
    for xx in (x, x.to(torch.bfloat16)):
        got = apply_packed(xx, p)
        assert got.shape == (b, c) and got.dtype == xx.dtype
        _close_rounded(got, apply_packed_ref(xx, p))
        assert torch.equal(apply_packed(xx[:1], p)[0], got[0])
        assert torch.equal(apply_packed(xx, p), got)
        lo, hi = b // 3, b // 3 + min(b, 37)
        assert torch.equal(apply_packed(xx[lo:hi], p), got[lo:hi])
    _close(apply_packed(x, p), x @ torch.from_numpy(w).to(dev), 1e-3)
    for bad in (float("nan"), float("inf"), -float("inf")):
        xn = x.clone()
        xn[:, 0] = bad
        xp = torch.nn.functional.pad(xn, (0, p.k_padded - k))
        _same_nonfinite(vusa_spmm(xp, p.values, p.row_idx),
                        ref.vusa_spmm_ref(xp, p.values, p.row_idx))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize(
    "m,k,n",
    [(8, 128, 128), (128, 256, 384), (16, 64, 256), (49, 9, 32), (8450, 256, 384),
     (49, 4608, 512), (196, 2304, 256), (3136, 576, 64), (1, 512, 1000)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_matmul_matches_plain_on_card(m, k, n, dtype):
    """B6 vs its plain version at the shapes of tests/test_kernels.py,
    ragged ones (M = 49 and 8450 take bm = 1, K = 9, N = 32; 8450 rows run
    many row blocks) and ResNet-18's split and 64-column shapes (through
    ``dense_matmul`` with whole-dimension blocks where K or N is outside
    ``ops.matmul``'s contract), fp32 and bf16 operands; two calls bitwise
    equal; rows independent of M; a NaN in x[:, 0] reaches the outputs it
    reaches in the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dev, dtype)
    in_contract = all(d <= 128 or d % 128 == 0 for d in (k, n))
    mm = matmul if in_contract else (lambda a, b: dense_matmul(a, b, 1, n, k))
    got = mm(x, w)
    assert got.shape == (m, n) and got.dtype == torch.float32
    _close(got, ref.dense_matmul_ref(x, w))
    assert torch.equal(dense_matmul(x[:1], w, 1, n, k)[0], got[0])
    assert torch.equal(mm(x, w), got)
    lo, hi = m // 3, m // 3 + min(m, 37)
    assert torch.equal(mm(x[lo:hi], w), got[lo:hi])
    for bad in (float("nan"), float("inf"), -float("inf")):
        xn = x.clone()
        xn[:, 0] = bad
        _same_nonfinite(mm(xn, w), ref.dense_matmul_ref(xn, w))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["vusa_spmm", "dense_matmul"])
def test_many_rows_run_in_row_chunks_on_card(kernel):
    """B5/B6 at K = 4608 (36 slices) and 1024 columns with 1000 rows, whose
    partials exceed the 64 MiB workspace: the call runs three row chunks
    (six CUDA launches, counted by the library itself), stays within 1e-4 of
    the plain version, and its rows equal a sub-batch's bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    m, k, n = 1000, 4608, 1024
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
    w = _sparse(rng, k, n, 0.85)
    if kernel == "vusa_spmm":
        p = pack_linear(w, 32, 8, 128, device=dev)
        mod, call, want = spmm_mod, (lambda a: apply_packed(a, p)), apply_packed_ref(x, p)
        pl = tile_plan.plan(p.values.shape[1] * p.values.shape[2])
    else:
        wt = torch.from_numpy(w).to(dev)
        mod, call, want = dense_mod, (lambda a: matmul(a, wt)), ref.dense_matmul_ref(x, wt)
        pl = tile_plan.plan(k)
    assert pl.S == 36 and len(tile_plan.row_chunks(pl, m, n)) == 3
    c0 = mod.cuda_launches()
    got = call(x)
    torch.cuda.synchronize()
    assert mod.cuda_launches() - c0 == tile_plan.cuda_launches(pl, m, n) == 6
    _close(got, want)
    assert torch.equal(call(x[450:520]), got[450:520])
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_kernels_match_plain_on_card():
    """Kernel vs plain version on the card, and row-wise batch invariance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)

    for k, c in ((768, 768), (100, 300)):
        for sparsity in (0.0, 0.85, 0.99):
            w = _sparse(rng, k, c, sparsity)
            p = pack_linear_rows(w, device=dev)
            x = torch.from_numpy(rng.normal(size=(4, k)).astype(np.float32)).to(dev)
            got = vusa_packed_matmul(x, p.values, p.positions)
            _close(got, ref.vusa_packed_ref(x, p.values, p.positions))
            one = vusa_packed_matmul(x[:1].contiguous(), p.values, p.positions)
            assert torch.equal(one[0], got[0])
            xb = x.to(torch.bfloat16)
            _close(vusa_packed_matmul(xb, p.values, p.positions),
                   ref.vusa_packed_ref(xb, p.values, p.positions))
            y = apply_row_packed(xb, p)  # sliced to c, cast back to bf16
            assert y.shape == (4, c) and y.dtype == torch.bfloat16
            _close(y, apply_row_packed_ref(xb, p), 1e-2)  # one bf16 rounding of the output
    wg, wu = _sparse(rng, 256, 600, 0.85), _sparse(rng, 256, 600, 0.85)
    wd = _sparse(rng, 600, 256, 0.85)
    pg, pu = pack_linear_rows(wg, device=dev), pack_linear_rows(wu, device=dev)
    pd = pack_linear_rows_t(wd, device=dev)
    x = torch.from_numpy(rng.normal(size=(4, 256)).astype(np.float32)).to(dev)
    got = apply_fused_mlp(x, pg, pu, pd)
    _close(got, apply_fused_mlp_ref(x, pg, pu, pd))
    assert torch.equal(apply_fused_mlp(x[:1], pg, pu, pd)[0], got[0])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["int8", "int4"])
def test_quantized_cuda_kernels_match_plain_on_card(dt):
    """The int8/int4 routes of both kernels (the Pallas ``_qkernel`` and
    ``_fused_mlp_qkernel``) vs their plain versions, odd slot counts and
    all-zero rows included, and row-wise batch invariance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    for k, c, a in ((768, 768, 16), (100, 300, 3)):
        for sparsity in (0.0, 0.85, 0.99):
            w = _sparse(rng, k, c, sparsity)
            w[7] = 0.0
            p = pack_linear_rows(w, a=a, device=dev, value_dtype=dt)
            x = torch.from_numpy(rng.normal(size=(4, k)).astype(np.float32)).to(dev)
            for xx in (x, x.to(torch.bfloat16)):
                got = vusa_packed_matmul(xx, p.values, p.positions, p.scales, value_dtype=dt)
                _close(got, ref.vusa_packed_ref(xx, p.values, p.positions, p.scales,
                                                value_dtype=dt))
                one = vusa_packed_matmul(xx[:1].contiguous(), p.values, p.positions, p.scales,
                                         value_dtype=dt)
                assert torch.equal(one[0], got[0])
    # the rebuilt values are bitwise the plain dequant: x = I picks out each row
    p = pack_linear_rows(_sparse(rng, 128, 256, 0.5), device=dev, value_dtype=dt)
    eye = torch.eye(128, device=dev)
    want = ref.unpack_dense(ref.dequantize_values(p.values, p.scales, dt), p.positions)
    assert torch.equal(vusa_packed_matmul(eye, p.values, p.positions, p.scales, value_dtype=dt),
                       want)
    wg, wu = _sparse(rng, 256, 600, 0.85), _sparse(rng, 256, 600, 0.85)
    wd = _sparse(rng, 600, 256, 0.85)
    pg = pack_linear_rows(wg, device=dev, value_dtype=dt)
    pu = pack_linear_rows(wu, device=dev, value_dtype=dt)
    pd = pack_linear_rows_t(wd, device=dev, value_dtype=dt)
    x = torch.from_numpy(rng.normal(size=(4, 256)).astype(np.float32)).to(dev)
    got = apply_fused_mlp(x, pg, pu, pd)
    _close(got, apply_fused_mlp_ref(x, pg, pu, pd))
    assert torch.equal(apply_fused_mlp(x[:1], pg, pu, pd)[0], got[0])
    torch.cuda.synchronize()


def _random_pack(rng, t, k, s, kind, dev):
    """A (T, K, S) pack drawn at random, not from a weight: positions in
    [-1, 128) (so some lanes repeat within a row and, at m < 128, some lie
    past the window), idle slots holding NaN values, ``kind``'s values
    (and scales)."""
    pos = rng.integers(-1, 128, size=(t, k, s)).astype(np.int8)
    scales = None
    if kind in ("float32", "bfloat16"):
        vals = rng.normal(size=(t, k, s)).astype(np.float32)
        vals[pos < 0] = np.nan
        values = torch.from_numpy(vals).to(dev, getattr(torch, kind))
    else:
        nbytes = s // 2 if kind == "int4" else s
        values = torch.from_numpy(rng.integers(-128, 128, size=(t, k, nbytes)).astype(np.int8))
        values = values.to(dev)
        scales = torch.from_numpy(rng.random((t, k)).astype(np.float32) * 0.1).to(dev)
    return values, torch.from_numpy(pos).to(dev), scales


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("k", [768, 1000, 3072])
@pytest.mark.parametrize("s,m", [(3, 100), (48, 128)])
def test_row_packed_matmul_matches_plain_on_card(kind, k, s, m):
    """B1/B3 vs the plain version within 1e-4 of the largest output, fp32
    and bf16 x, B = 1, 4 and 9; row 0 of each call bitwise equal to B = 1;
    the CUDA launches counted per call equal to ``row_plan``'s; and the
    kernel vs ``ref.vusa_packed_sliced_ref``, its order of operations
    emulated on the CPU, within 8 fp32 ulps of the largest output (the
    emulation's fp64 product and sum may round twice where the kernel's
    fmaf rounds once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(k + s)
    s = s + (s % 2 if kind == "int4" else 0)  # int4 pairs its slots in bytes
    vd = kind if kind in ("int8", "int4") else "dense"
    values, positions, scales = _random_pack(rng, 3, k, s, kind, dev)
    x = torch.from_numpy(rng.normal(size=(9, k)).astype(np.float32)).to(dev)
    plan = row_plan.row_plan(k)
    cpu = [None if a is None else a.cpu() for a in (values, positions, scales)]
    for xx in (x, x.to(torch.bfloat16)):
        one = packed_mod.vusa_packed_matmul(xx[:1], values, positions, scales, m=m,
                                            value_dtype=vd)
        emu = ref.vusa_packed_sliced_ref(xx.cpu(), *cpu, m=m, value_dtype=vd)
        for b in (1, 4, 9):
            c0 = packed_mod.cuda_launches("vusa_packed_matmul")
            got = packed_mod.vusa_packed_matmul(xx[:b], values, positions, scales, m=m,
                                                value_dtype=vd)
            torch.cuda.synchronize()
            assert (packed_mod.cuda_launches("vusa_packed_matmul") - c0
                    == row_plan.cuda_launches(plan, b, 3 * m) == 2)
            assert got.shape == (b, 3 * m) and bool(torch.isfinite(got).all())
            _close(got, ref.vusa_packed_ref(xx[:b], values, positions, scales, m, vd))
            assert torch.equal(got[0], one[0])
            ulps = 8 * torch.finfo(torch.float32).eps * float(emu.abs().max())
            assert float((got.cpu() - emu[:b]).abs().max()) <= ulps
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("k,d,slots,m",
                         [(1000, 1000, (3, 48, 5), 100), (768, 700, (48, 16, 32), 128)])
def test_fused_mlp_matches_sliced_on_card(kind, k, d, slots, m):
    """B2/B4 vs the plain version within 1e-4 of the largest output, fp32
    and bf16 x, B = 1, 4 and 9; row 0 of each call bitwise equal to B = 1;
    the CUDA launches counted per call equal to ``mlp_plan``'s; and the
    kernel vs ``ref.vusa_fused_mlp_sliced_ref``, its order of operations
    emulated on the CPU, within 8 fp32 ulps of the largest output plus 4
    ulps of each output's magnitude sum |h| @ |Wd|: the kernel's expf in
    silu may differ from the CPU's exp by 2 ulps, which moves each h by at
    most about 3 ulps, and the down sum carries that through |v| * |h| (the
    8 ulps cover the emulation's rare double rounding, as for B1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(k + d)
    t = 3
    vd = kind if kind in ("int8", "int4") else "dense"
    packs = []
    for rows, s in zip((k, k, d), slots):
        packs.append(_random_pack(rng, t, rows, s + (s % 2 if kind == "int4" else 0), kind, dev))
    (gv, gp, gs), (uv, up, us), (dv, dp, ds) = packs
    args = (gv, gp, uv, up, dv, dp, gs, us, ds)
    cpu = [None if a is None else a.cpu() for a in args]
    x = torch.from_numpy(rng.normal(size=(9, k)).astype(np.float32)).to(dev)
    plan = mlp_plan.mlp_plan(k, d)
    eps = torch.finfo(torch.float32).eps
    for xx in (x, x.to(torch.bfloat16)):
        one = packed_mod.vusa_fused_mlp_matmul(xx[:1], *args, m=m, value_dtype=vd)
        emu = ref.vusa_fused_mlp_sliced_ref(xx.cpu(), *cpu, m=m, value_dtype=vd)
        # |h| @ |Wd| per output: what an error in h moves the output by
        wg, wu, wd = (ref.unpack_dense(ref.dequantize_values(v, sc, vd), p, m)
                      for v, p, sc in ((cpu[0], cpu[1], cpu[6]), (cpu[2], cpu[3], cpu[7]),
                                       (cpu[4], cpu[5], cpu[8])))
        xf = xx.cpu().float()
        mag = (torch.nn.functional.silu(xf @ wg) * (xf @ wu)).abs() @ wd.abs().T
        for b in (1, 4, 9):
            c0 = packed_mod.cuda_launches("vusa_fused_mlp_matmul")
            got = packed_mod.vusa_fused_mlp_matmul(xx[:b], *args, m=m, value_dtype=vd)
            torch.cuda.synchronize()
            assert (packed_mod.cuda_launches("vusa_fused_mlp_matmul") - c0
                    == mlp_plan.cuda_launches(plan, b, d, t) == 2)
            assert got.shape == (b, d) and bool(torch.isfinite(got).all())
            _close(got, ref.vusa_fused_mlp_ref(xx[:b], *args, m, vd))
            assert torch.equal(got[0], one[0])
            tol = 8 * eps * float(emu.abs().max()) + 4 * eps * mag[:b]
            assert bool(((got.cpu() - emu[:b]).abs() <= tol).all())
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_each_library_counts_its_own_cuda_launches():
    """The B1-B4, B5 and B6 libraries count the CUDA launches they issue,
    each its own: one B5 call with one slice (1 launch), one B6 call at
    K = 4608 (36 slices: the tile kernel and the ordered sum, 2 launches),
    B1 calls at K = 64 (one slice, 1 launch) and K = 768 (12 slices, 2),
    and one fused MLP (as its ``mlp_plan`` counts: the cluster kernel and
    the ordered sum of its window partials)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    p = pack_linear(_sparse(rng, 100, 64, 0.5), 32, 8, 128, device=dev)
    x5 = torch.from_numpy(rng.normal(size=(4, 100)).astype(np.float32)).to(dev)
    x6 = torch.from_numpy(rng.normal(size=(8, 4608)).astype(np.float32)).to(dev)
    w6 = torch.from_numpy(rng.normal(size=(4608, 128)).astype(np.float32)).to(dev)
    r64, r768 = (pack_linear_rows(_sparse(rng, k, 256, 0.85), device=dev) for k in (64, 768))
    x64, x256, x768 = (torch.from_numpy(rng.normal(size=(4, k)).astype(np.float32)).to(dev)
                       for k in (64, 256, 768))
    wg, wu = _sparse(rng, 256, 300, 0.85), _sparse(rng, 256, 300, 0.85)
    pg, pu = pack_linear_rows(wg, device=dev), pack_linear_rows(wu, device=dev)
    pd = pack_linear_rows_t(_sparse(rng, 300, 256, 0.85), device=dev)

    def run():
        apply_packed(x5, p)
        matmul(x6, w6)
        apply_row_packed(x64, r64)
        apply_row_packed(x768, r768)
        apply_fused_mlp(x256, pg, pu, pd)

    run()  # every library loaded before the first read
    entries = ("vusa_packed_matmul", "vusa_fused_mlp_matmul", "empty_kernel")
    c5, c6 = spmm_mod.cuda_launches(), dense_mod.cuda_launches()
    cp = {e: packed_mod.cuda_launches(e) for e in entries}
    run()
    torch.cuda.synchronize()
    assert (spmm_mod.cuda_launches() - c5, dense_mod.cuda_launches() - c6) == (1, 2)
    got = {e: packed_mod.cuda_launches(e) - n for e, n in cp.items()}
    fused = mlp_plan.cuda_launches(mlp_plan.mlp_plan(256, 256), 4, 256, pg.values.shape[0])
    assert got == {"vusa_packed_matmul": 1 + 2, "vusa_fused_mlp_matmul": fused, "empty_kernel": 0}
    assert sum(got.values()) == 3 + fused


# ---------------------------------------------------------------------------
# the engine on the card: CUDA-graph loop, speculative decoding, no syncs
# ---------------------------------------------------------------------------

ROUTES = {"dense": {}, "fp32": {"packed_weights": "all"},
          "int8": {"packed_weights": "all", "packed_values": "int8"},
          "int4": {"packed_weights": "all", "packed_values": "int4"}}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _edge2():
    """Full-width ``vusa_edge`` (fp32 activations) cut to 2 layers."""
    return dataclasses.replace(get_config("vusa_edge"), n_layers=2, dtype="float32")


def _tiered(tree):
    """The tier structure of ``tests/test_spec_decode.py::_tiered``: the top
    1 % of magnitudes kept, the next 14 % scaled by 0.03, zeros elsewhere."""
    if isinstance(tree, dict):
        return {k: _tiered(v) for k, v in tree.items()}
    if tree.ndim < 2:
        return tree
    a = tree.abs().flatten().sort(descending=True).values
    t1 = a[max(int(0.01 * a.numel()) - 1, 0)]
    t2 = a[max(int(0.15 * a.numel()) - 1, 0)]
    return torch.where(tree.abs() >= t1, tree,
                       torch.where(tree.abs() >= t2, tree * 0.03, torch.zeros_like(tree)))


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("route", list(ROUTES))
def test_graph_loop_equals_eager_loop_on_card(route, temperature):
    dev = _card()
    cfg = _edge2()
    params = prune_tree(build_model(cfg).init(0, device=dev), 0.85)
    eng = Engine(cfg, params, ServeConfig(max_len=32, temperature=temperature,
                                          **ROUTES[route]), device=dev)
    prompts = np.random.default_rng(1).integers(1, cfg.vocab, (4, 8)).astype(np.int32)
    graph = eng.generate(prompts, max_new=12)
    eng.sc = dataclasses.replace(eng.sc, fused=False)
    eager = eng.generate(prompts, max_new=12)
    np.testing.assert_array_equal(graph["tokens"], eager["tokens"])
    assert graph["finite"] and eager["finite"]
    if route != "dense":  # replays x the launches captured in one step
        vd = "dense" if route == "fp32" else route
        got = eng.graph_launches()
        assert got["vusa_packed_matmul"][vd] == 11 * (4 * cfg.n_layers + 1)
        assert got["vusa_fused_mlp_matmul"][vd] == 11 * cfg.n_layers


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("route", ["dense", "fp32", "int8"])
def test_spec_equals_plain_decode_on_card(route, temperature):
    dev = _card()
    cfg = _edge2()
    params = _tiered(build_model(cfg).init(0, device=dev))
    sc = ServeConfig(max_len=48, temperature=temperature, **ROUTES[route])
    plain = Engine(cfg, params, sc, device=dev)
    spec = Engine(cfg, params, dataclasses.replace(sc, speculative=True), device=dev)
    for seed in (3, 4):
        prompt = np.random.default_rng(seed).integers(1, cfg.vocab, (1, 8)).astype(np.int32)
        want = plain.generate(prompt, max_new=24)
        got = spec.generate(prompt, max_new=24)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert got["finite"] and got["spec_proposed"] == 4 * got["spec_rounds"]


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fp32", "int8", "int4"])
def test_batched_verify_equals_sequential_steps_on_card(route):
    """The full pack verifies 5 tokens in one pass through B1-B4 at 5 rows;
    logits and cache must be bitwise 5 single-token steps."""
    dev = _card()
    cfg = _edge2()
    params = prune_tree(build_model(cfg).init(0, device=dev), 0.85)
    eng = Engine(cfg, params, ServeConfig(max_len=32, **ROUTES[route]), device=dev)
    toks = torch.tensor([[11, 7, 300, 4000, 31999]], device=dev)
    with torch.no_grad():
        _, c1 = eng.prime(np.array([[1, 2, 3, 4]], np.int32))
        _, c2 = eng.prime(np.array([[1, 2, 3, 4]], np.int32))
        multi, c1 = lm_decode_step_packed(eng.params, eng.packed, toks, c1, cfg)
        seq = torch.cat([lm_decode_step_packed(eng.params, eng.packed, toks[:, i : i + 1], c2,
                                               cfg)[0] for i in range(5)], dim=1)
    assert torch.equal(multi, seq)
    assert torch.equal(c1["k"], c2["k"]) and torch.equal(c1["v"], c2["v"])
    assert int(c1["pos"]) == int(c2["pos"]) == 9


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["dense", "fp32"])
def test_decode_step_makes_no_host_sync_on_card(route):
    dev = _card()
    cfg = _edge2()
    params = prune_tree(build_model(cfg).init(0, device=dev), 0.85)
    eng = Engine(cfg, params, ServeConfig(max_len=32, fused=False, temperature=1.0,
                                          **ROUTES[route]), device=dev)
    tok, cache = eng.prime(np.array([[1, 2, 3, 4]], np.int32))
    noise = eng.gumbel_noise(1, 1)
    eng.decode_segment(tok, cache, 1, noise)  # kernels built and loaded first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            eng.decode_segment(tok, cache, 1, noise)
            if route == "fp32":
                lm_decode_step_packed(eng.params, eng.packed, tok.repeat(1, 5), cache, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
