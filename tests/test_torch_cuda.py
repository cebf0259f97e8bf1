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
(``torch.cuda.set_sync_debug_mode("error")``).  The scheduler's pool step
(fp32 activations, where batched GEMMs and reductions part from one-row
ones on the card): row i at 4 rows bitwise a B = 1 step on its cache row,
slot pool and paged pool, all four routes; the scheduler's graph tokens
equal the eager pool step's and, under sequential admission, one-shot
``generate``'s at B = 1, greedy and sampled; one pool step makes no host
sync.

The decoder-only families at their own widths: B1 at qwen3_8b's and
qwen2_0_5b's projections and at the untied heads of internlm2_1_8b and
qwen3_8b (one 8-row tile a launch there), B2 at their MLPs, each within
1e-4 of its plain version with rows bitwise B = 1; qwen2 (qkv bias, tied
head, fp32 and int8 values), internlm2, olmoe (dense) and paligemma
(patch embeddings) at full width cut to 2 layers, the graph loop's tokens
equal to the eager loop's.

The hybrid, ssm and encdec families (smoke widths, bf16 activations, the
hybrid at 5 layers): the graph loop's tokens equal the eager loop's,
greedy and sampled, the recurrent families past ``max_len``; one decode
step (and the pool step's per-row form) makes no host sync; the
scheduler's completions equal one-shot ``generate`` at B = 1.

The mesh: two gloo ranks sharing the card hold the sharded B1 (column
windows all-gathered) and the gathered-partial B2 (window partials
all-gathered, summed by the kernel's ordered sum) bitwise against the
single-device kernels at ``vusa_edge``'s widths, a pad window included.

Training on the card: full-width ``vusa_edge`` (bf16 activations, remat)
cut to 2 layers trains a few steps with pruning through the ``Trainer``;
a run restored from its step-4 checkpoint (a mask-refresh step) ends
bitwise equal to the uninterrupted run (params, moments, step), and the
flash-attention backward on the card is within 1e-4 of its own run on the
CPU.
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
from repro_torch.train import TrainConfig, Trainer, TrainHParams


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


# ---------------------------------------------------------------------------
# the scheduler's pool step on the card
# ---------------------------------------------------------------------------


def _pool_caches(eng, cfg, lens, paged: bool):
    """``len(lens)`` caches primed from prompts of ``lens`` tokens, and the
    pool cache (slot pool, or a paged pool with pages of 8) holding them."""
    from repro_torch.models.cache import (PagedLayout, bind_slot_pages, init_paged_pool,
                                          paged_view, write_prefill_pages, write_slots)

    rng = np.random.default_rng(9)
    primed = [eng.prime(rng.integers(1, cfg.vocab, (1, n)).astype(np.int32)) for n in lens]
    batched = {k: torch.cat([c[k] for _, c in primed], dim=1) for k in ("k", "v")}
    n, max_len = len(lens), eng.sc.max_len
    if paged:
        lay = PagedLayout.build(n, max_len, 8)
        pool = init_paged_pool(eng.model.cache_specs(1, max_len), lay, eng.device)
        rows = (lay.reserved + np.arange(n * lay.n_pages)).reshape(n, -1)
        write_prefill_pages(pool["arena"], rows, batched)
        bind_slot_pages(pool["table"], pool["pos"], list(range(n)), rows, lens)
        return primed, paged_view(pool)
    pool = eng.model.init_slot_cache(n, max_len, device=eng.device)
    write_slots(pool, list(range(n)), {**batched, "pos": None},
                eng.model.cache_batch_axes(max_len), lens)
    return primed, pool


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("route", list(ROUTES))
def test_pool_step_rows_equal_b1_steps_on_card(route, paged):
    """The pool step at 4 rows (``rowwise``) on caches at ragged positions:
    row i bitwise a B = 1 step on cache i, fp32 activations (where batched
    GEMMs and reductions part from one-row ones on the card)."""
    dev = _card()
    cfg = _edge2()
    params = prune_tree(build_model(cfg).init(0, device=dev), 0.85)
    eng = Engine(cfg, params, ServeConfig(max_len=32, **ROUTES[route]), device=dev)
    with torch.no_grad():
        primed, pool = _pool_caches(eng, cfg, [3, 9, 5, 12], paged)
        token = torch.cat([t for t, _ in primed])
        many = eng._logits(token, pool, eng.packed, rowwise=True)
        for i, (_, c) in enumerate(primed):
            assert torch.equal(many[i : i + 1], eng._logits(token[i : i + 1], c, eng.packed)), i


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("route", ["dense", "fp32", "int4"])
def test_scheduler_graph_equals_eager_pool_and_one_shot_on_card(route, temperature):
    """The scheduler's pool step replayed as a CUDA graph gives the eager
    pool step's tokens, and under sequential admission each completion
    equals one-shot generate at B = 1 with its seed, bitwise; the graph's
    B1-B4 launches are replays x the step's."""
    from repro_torch.serve import Request, Scheduler

    dev = _card()
    cfg = _edge2()
    params = prune_tree(build_model(cfg).init(0, device=dev), 0.85)
    sc = ServeConfig(max_len=48, temperature=temperature, **ROUTES[route])
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, n).astype(np.int32), max_new=m, seed=7 + i)
            for i, (n, m) in enumerate([(5, 12), (17, 6), (9, 10), (3, 8), (12, 7)])]
    eng = Engine(cfg, params, sc, device=dev)
    sched = Scheduler(eng, slots=3, segment=4, admission="sequential")
    graph = sched.run([dataclasses.replace(r) for r in reqs])
    steps = sched.stats()["segments"] * 4
    eager_eng = Engine(cfg, params, sc, device=dev)
    eager_eng._graphed = lambda: False
    eager = Scheduler(eager_eng, slots=3, segment=4, admission="sequential").run(
        [dataclasses.replace(r) for r in reqs])
    oracle = Engine(cfg, params, sc, device=dev)
    for rid, r in enumerate(reqs):
        np.testing.assert_array_equal(graph[rid].tokens, eager[rid].tokens)
        oracle.sc.seed = r.seed
        np.testing.assert_array_equal(
            graph[rid].tokens, oracle.generate(r.prompt[None], max_new=r.max_new)["tokens"][0])
    if route != "dense":
        vd = "dense" if route == "fp32" else route
        got = eng.graph_launches()
        assert got["vusa_packed_matmul"][vd] == steps * (4 * cfg.n_layers + 1)
        assert got["vusa_fused_mlp_matmul"][vd] == steps * cfg.n_layers


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_pool_step_makes_no_host_sync_on_card(paged):
    """One pool step (sampled, so the per-slot noise gather runs too) makes
    no host sync."""
    from repro_torch.serve import Scheduler

    dev = _card()
    cfg = _edge2()
    params = prune_tree(build_model(cfg).init(0, device=dev), 0.85)
    eng = Engine(cfg, params, ServeConfig(max_len=32, temperature=1.0, packed_weights="all",
                                          page_size=8 if paged else 0), device=dev)
    eng._graphed = lambda: False
    sched = Scheduler(eng, slots=3, segment=2)  # the two steps write columns 0 and 1
    eng.prepare_pool(sched._pool)
    with torch.no_grad():
        eng._pool_step(sched._pool)  # kernels built and loaded first
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng._pool_step(sched._pool)
        finally:
            torch.cuda.set_sync_debug_mode("default")


# ---------------------------------------------------------------------------
# the scheduler's speculative rounds and the failure model on the card
# ---------------------------------------------------------------------------


def _spec_reqs(cfg, n=5):
    from repro_torch.serve import Request

    rng = np.random.default_rng(21)
    return [Request(prompt=rng.integers(1, cfg.vocab, 4 + 3 * i).astype(np.int32),
                    max_new=10 + i, seed=40 + i) for i in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("route", ["dense", "fp32", "int8"])
def test_spec_scheduler_graph_equals_plain_on_card(route, paged, temperature):
    """The pool's speculative round replayed as a CUDA graph: every
    completion bitwise the plain scheduler's (slot pool: sequential
    admission, 3 slots for 5 requests; paged: 5 slots, one admission
    round); the graph's B1-B4 launches are rounds x (draft_k drafter steps
    on the float route + one verify on the verifier's)."""
    from repro_torch.serve import Scheduler

    dev = _card()
    cfg = _edge2()
    params = _tiered(build_model(cfg).init(0, device=dev))
    sc = ServeConfig(max_len=96, temperature=temperature, page_size=8 if paged else 0,
                     **ROUTES[route])
    reqs = _spec_reqs(cfg)
    slots = 5 if paged else 3

    def run(spec):
        eng = Engine(cfg, params, dataclasses.replace(sc, speculative=spec), device=dev)
        sched = Scheduler(eng, slots=slots, segment=3, admission="sequential")
        return eng, sched, sched.run([dataclasses.replace(r) for r in reqs])

    _, _, want = run(False)
    eng, sched, got = run(True)
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
    rounds = sched.stats()["segments"] * 3
    per = {"vusa_packed_matmul": 4 * cfg.n_layers + 1, "vusa_fused_mlp_matmul": cfg.n_layers}
    vd = {"dense": None, "fp32": "dense", "int8": "int8"}[route]
    got_l = eng.graph_launches()
    for name, n in per.items():
        want_l = {"dense": rounds * 4 * n}
        if vd is not None:
            want_l[vd] = want_l.get(vd, 0) + rounds * n
        assert {k: v for k, v in got_l[name].items() if v} == want_l, name


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("route", ["dense", "fp32", "int4"])
def test_pool_spec_round_rows_equal_b1_rounds_on_card(route, paged):
    """One pool round at 4 slots (a verify of 20 rows through B1-B4) on
    caches at ragged positions: slot b's tokens, emitted count and K/V rows
    bitwise a B = 1 ``_spec_round`` on its cache; no host sync."""
    from repro_torch.models.cache import paged_read_slot, read_slot
    from repro_torch.serve.engine import _SpecLoop

    dev = _card()
    cfg = _edge2()
    params = _tiered(build_model(cfg).init(0, device=dev))
    eng = Engine(cfg, params, ServeConfig(max_len=32, speculative=True, **ROUTES[route]),
                 device=dev)
    lens = [3, 9, 5, 12]
    with torch.no_grad():
        primed, pool = _pool_caches(eng, cfg, lens, paged)
        st = eng.new_pool(4, 1, spec=True)
        if paged:
            st.paged = True
            st.cache = {"arena": {k: pool[k] for k in ("k", "v")}, "table": pool["table"],
                        "pos": pool["pos"]}
        else:
            st.cache = pool
        st.token.copy_(torch.cat([t for t, _ in primed]))
        eng._pool_spec_round(st)  # kernels built and loaded first
        torch.cuda.synchronize()
        for b, (tok, c) in enumerate(primed):
            one = _SpecLoop(tok.clone(), {k: v.clone() for k, v in c.items()},
                            torch.zeros((), dtype=torch.long, device=dev),
                            torch.zeros((), dtype=torch.long, device=dev),
                            torch.zeros((16,), dtype=torch.long, device=dev),
                            torch.ones((16,), dtype=torch.bool, device=dev), None)
            eng._spec_round(one)
            nem = int(one.count)
            assert nem == int(st.nems[b, 0])
            assert torch.equal(one.buf[:nem], st.toks[b, 0, :nem])
            row = (paged_read_slot(st.cache, b, 32) if paged
                   else read_slot(st.cache, b, eng.model.cache_batch_axes(32)))
            p = int(one.cache["pos"])
            assert p == int(row["pos"]) == lens[b] + nem
            for k in ("k", "v"):
                assert torch.equal(one.cache[k][:, :, :p], row[k][:, :, :p]), (b, k)
        st.col.zero_()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng._pool_spec_round(st)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [False, True])
def test_mid_run_quarantine_switches_graphs_on_card(spec):
    """A cache NaN under packed weights quarantines the pack at the first
    sync; the pool replays its dense twin, captured at the run's start:
    the poisoned request completes FAILED_FALLBACK_OK with its clean dense
    tokens, and each other slot's tokens are bitwise a B = 1 run that
    emits what it emitted by the first sync on the pack, then steps dense
    (nothing was captured on the live pool)."""
    from repro_torch.serve import FaultConfig, Scheduler, Status

    dev = _card()
    cfg = _edge2()
    params = _tiered(build_model(cfg).init(0, device=dev))
    sc = ServeConfig(max_len=96, packed_weights="all")
    reqs = _spec_reqs(cfg, 3)
    eng = Engine(cfg, params, dataclasses.replace(
        sc, speculative=spec, faults=FaultConfig(cache_nan_rids=(1,))), device=dev)
    sched = Scheduler(eng, slots=3, segment=3, admission="sequential")
    first_sync = {}

    def note(s):
        if not first_sync:
            first_sync.update({sl.rid: len(sl.tokens) for sl in s._slot if sl.active})

    done = sched.run([dataclasses.replace(r) for r in reqs], on_sync=note)
    assert eng.quarantined and sched.stats()["quarantined"] == 1
    assert done[1].status is Status.FAILED_FALLBACK_OK
    dense = Engine(cfg, params, ServeConfig(max_len=96, seed=reqs[1].seed), device=dev)
    np.testing.assert_array_equal(
        done[1].tokens, dense.generate(reqs[1].prompt[None], max_new=reqs[1].max_new)["tokens"][0])
    for rid in (0, 2):
        # tokens delivered by the first sync (all of them if it retired there)
        n1 = first_sync.get(rid, len(done[rid].tokens))
        oracle = Engine(cfg, params, sc, device=dev)
        with torch.no_grad():
            first, c = oracle.prime(reqs[rid].prompt[None])
            a, _, last, c = oracle.decode_segment(first, c, n1 - 1)
            assert oracle.quarantine_packed()
            b, _, _, _ = oracle.decode_segment(last, c, reqs[rid].max_new - n1)
        assert done[rid].status is Status.OK
        np.testing.assert_array_equal(done[rid].tokens,
                                      torch.cat([first, a, b], dim=1)[0].cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [False, True])
def test_reload_packed_recaptures_graphs_on_card(spec):
    """After a scheduler run captured its pool graphs, ``reload_packed``
    with other params drops them; the same scheduler's next run captures
    afresh on its used pool and its tokens are a fresh engine's on the new
    params, not a stale replay of the old pack."""
    from repro_torch.serve import Scheduler

    dev = _card()
    cfg = _edge2()
    raw = build_model(cfg).init(0, device=dev)
    p85, p90 = prune_tree(raw, 0.85), prune_tree(raw, 0.90)
    sc = ServeConfig(max_len=96, temperature=1.0, packed_weights="all", speculative=spec)
    reqs = _spec_reqs(cfg, 3)

    def run(sched):
        done = sched.run([dataclasses.replace(r) for r in reqs])
        return [done[rid].tokens for rid in sorted(done)]

    eng = Engine(cfg, p85, sc, device=dev)
    sched = Scheduler(eng, slots=3, segment=4, admission="sequential")
    old = run(sched)
    assert eng.reload_packed(p90)
    new = run(sched)
    fresh = run(Scheduler(Engine(cfg, p90, sc, device=dev), slots=3, segment=4,
                          admission="sequential"))
    for a, b in zip(new, fresh):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(old, fresh))


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------


def _train_tc(**kw):
    base = dict(steps=8, global_batch=4, seq_len=64, prune_begin=2, prune_end=6,
                prune_every=2, log_every=100, token_range=256,
                hp=TrainHParams(lr=1e-3, warmup=2, total_steps=8))
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.gpu
def test_training_resume_is_bitwise_on_card(tmp_path):
    _card()
    cfg = dataclasses.replace(get_config("vusa_edge"), n_layers=2)  # bf16, remat on
    full = Trainer(cfg, _train_tc(), device="cuda").train()
    assert np.isfinite(full["final_loss"]) and full["sparsity"] == pytest.approx(0.85, abs=0.02)
    ck = str(tmp_path / "ck")
    assert Trainer(cfg, _train_tc(steps=4, ckpt_dir=ck, ckpt_every=4),
                   device="cuda").train()["steps_run"] == 4
    resumed = Trainer(cfg, _train_tc(ckpt_dir=ck, ckpt_every=100), device="cuda").train()
    assert resumed["steps_run"] == 4

    def leaves(o):
        trees = (o["params"], o["opt"].mu, o["opt"].nu)
        return [t for tree in trees for _, t in sorted(_flat(tree))] + [o["opt"].step]

    for a, b in zip(leaves(full), leaves(resumed)):
        assert torch.equal(a, b)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        yield from (_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)])


@pytest.mark.gpu
def test_flash_backward_on_card_matches_cpu():
    from repro_torch.models.layers import flash_attention_train

    _card()
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 520, 2, 2, 64), dtype=np.float32)
    k, v = (rng.standard_normal((2, 520, 2, 64), dtype=np.float32) for _ in range(2))
    dout = rng.standard_normal(q.shape, dtype=np.float32)
    grads = {}
    for dev in ("cpu", "cuda"):
        ts = [torch.from_numpy(a).to(dev).requires_grad_() for a in (q, k, v)]
        flash_attention_train(*ts, torch.arange(520, device=dev)).backward(
            torch.from_numpy(dout).to(dev))
        grads[dev] = [t.grad.cpu() for t in ts]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        _close(a, b, tol=1e-4)


# ---------------------------------------------------------------------------
# the decoder-only families at their own widths
# ---------------------------------------------------------------------------


def _card_sparse(k, c, seed, dev):
    """A (K, C) weight drawn on the card and pruned to 85 % by magnitude."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((k, c), generator=gen, device=dev) / k**0.5
    return prune_tree({"w": w}, 0.85)["w"]


@pytest.mark.gpu
@pytest.mark.parametrize("k,c", [(4096, 4096), (4096, 1024), (896, 896), (896, 128),
                                 (2048, 92672), (4096, 152064)])
def test_family_projections_and_heads_match_plain_on_card(k, c):
    """B1 at the projections of qwen3_8b (4096 -> 4096, 4096 -> 1024) and
    qwen2_0_5b (896 -> 896, 896 -> 128) and the untied heads of
    internlm2_1_8b and qwen3_8b (whose row plan takes one 8-row tile a
    launch): within 1e-4 of the plain version, rows 0 and B - 1 bitwise
    B = 1, the CUDA launches as ``row_plan`` counts them."""
    dev = _card()
    lin = pack_linear_rows(_card_sparse(k, c, k + c, dev))
    x = torch.from_numpy(np.random.default_rng(k).normal(size=(40, k)).astype(np.float32)).to(dev)
    plan = row_plan.row_plan(k)
    args = (lin.values, lin.positions)
    for xx in (x, x.to(torch.bfloat16)):
        one = [vusa_packed_matmul(xx[i : i + 1], *args) for i in range(40)]
        for b in (1, 4, 5, 40):
            c0 = packed_mod.cuda_launches("vusa_packed_matmul")
            got = vusa_packed_matmul(xx[:b], *args)
            torch.cuda.synchronize()
            assert (packed_mod.cuda_launches("vusa_packed_matmul") - c0
                    == row_plan.cuda_launches(plan, b, got.shape[1]))
            _close(got, ref.vusa_packed_ref(xx[:b], *args))
            assert torch.equal(got[0], one[0][0]) and torch.equal(got[b - 1], one[b - 1][0])


@pytest.mark.gpu
@pytest.mark.parametrize("d,ff", [(4096, 12288), (896, 4864)])
def test_family_fused_mlps_match_plain_on_card(d, ff):
    """B2 at qwen3_8b's and qwen2_0_5b's MLPs (512- and 128-row slices):
    within 1e-4 of the plain version, rows bitwise B = 1."""
    dev = _card()
    gate, up = (pack_linear_rows(_card_sparse(d, ff, s, dev)) for s in (1, 2))
    down_t = pack_linear_rows_t(_card_sparse(ff, d, 3, dev))
    args = (gate.values, gate.positions, up.values, up.positions, down_t.values,
            down_t.positions)
    x = torch.from_numpy(np.random.default_rng(d).normal(size=(40, d)).astype(np.float32)).to(dev)
    for xx in (x, x.to(torch.bfloat16)):
        for b in (1, 5, 40):
            got = packed_mod.vusa_fused_mlp_matmul(xx[:b], *args)
            _close(got, ref.vusa_fused_mlp_ref(xx[:b], *args))
            last = packed_mod.vusa_fused_mlp_matmul(xx[b - 1 : b], *args)
            assert torch.equal(got[b - 1], last[0])


def _card_init(cfg, dev):
    """``cfg``'s parameters drawn on the card with the port's std rule."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def build(tree):
        return {k: build(v) if isinstance(v, dict) else
                torch.randn(v.shape, generator=gen, device=dev)
                * (0.5 if v.init == "zeros" else v.scale / max(
                    v.shape[-2] if len(v.shape) >= 2 else v.shape[-1], 1) ** 0.5)
                for k, v in tree.items()}

    return build(build_model(cfg).specs())


@pytest.mark.gpu
@pytest.mark.parametrize("arch,route", [("qwen2_0_5b", "fp32"), ("qwen2_0_5b", "int8"),
                                        ("internlm2_1_8b", "fp32"), ("olmoe_1b_7b", "dense"),
                                        ("paligemma_3b", "dense")])
def test_family_graph_loop_equals_eager_on_card(arch, route):
    """Full width cut to 2 layers, biases and norm scales drawn: the
    CUDA-graph loop's greedy tokens equal the eager loop's, with the
    graph's B1/B2 launches replays x captured on the packed routes."""
    dev = _card()
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    params = prune_tree(_card_init(cfg, dev), 0.85)
    extras = None
    if cfg.family == "vlm":
        extras = {"patches": np.random.default_rng(2).normal(
            0, 0.02, (4, cfg.patch_tokens, cfg.d_model)).astype(np.float32)}
    max_len = cfg.patch_tokens + 8 + 12 + 4
    eng = Engine(cfg, params, ServeConfig(max_len=max_len, **ROUTES[route]), device=dev)
    prompts = np.random.default_rng(1).integers(1, cfg.vocab, (4, 8)).astype(np.int32)
    graph = eng.generate(prompts, max_new=12, extras=extras)
    eng.sc = dataclasses.replace(eng.sc, fused=False)
    eager = eng.generate(prompts, max_new=12, extras=extras)
    np.testing.assert_array_equal(graph["tokens"], eager["tokens"])
    assert graph["finite"] and eager["finite"]
    if route != "dense":
        vd = "dense" if route == "fp32" else route
        got = eng.graph_launches()
        head = 0 if cfg.tie_embeddings else 1
        assert got["vusa_packed_matmul"][vd] == 11 * (4 * cfg.n_layers + head)
        assert got["vusa_fused_mlp_matmul"][vd] == 11 * cfg.n_layers


# ---------------------------------------------------------------------------
# the recurrent and encoder-decoder families on the card
# ---------------------------------------------------------------------------


def _family_engine(arch, dev, **kw):
    """``arch``'s smoke config (the hybrid at 5 layers: a group and its
    tail) with bf16 activations, parameters from the port's init with the
    biases, gates and norm scales drawn, on the card; and the extras its
    ``generate`` takes (4 x 12 stand-in frames for whisper)."""
    from repro_torch.configs import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=5)
    params = _card_init(cfg, dev)
    extras = None
    if cfg.family == "encdec":
        extras = {"frames": np.random.default_rng(2).normal(
            0, 0.02, (4, 12, cfg.d_model)).astype(np.float32)}
    return Engine(cfg, params, ServeConfig(max_len=24, **kw), device=dev), extras


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "mamba2_2_7b", "whisper_tiny"])
def test_new_family_graph_loop_equals_eager_on_card(arch, temperature):
    """The CUDA-graph loop (the recurrent families' priming a graph too)
    gives the eager loop's tokens bitwise, greedy and sampled; the
    recurrent families decode past ``max_len``, two lengths of it through
    one step graph replayed in chunks."""
    dev = _card()
    eng, extras = _family_engine(arch, dev, temperature=temperature)
    prompts = np.random.default_rng(1).integers(1, eng.cfg.vocab, (4, 8)).astype(np.int32)
    lengths = (12,) if arch == "whisper_tiny" else (30, 53)
    graphs = [eng.generate(prompts, max_new=n, extras=extras) for n in lengths]
    assert [key[0] for key in eng._graphs].count("step") == 1
    eng.sc = dataclasses.replace(eng.sc, fused=False)
    for n, graph in zip(lengths, graphs):
        eager = eng.generate(prompts, max_new=n, extras=extras)
        np.testing.assert_array_equal(graph["tokens"], eager["tokens"])
        assert graph["finite"] and eager["finite"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "mamba2_2_7b", "whisper_tiny"])
def test_new_family_decode_step_makes_no_host_sync_on_card(arch):
    dev = _card()
    eng, extras = _family_engine(arch, dev, fused=False, temperature=1.0)
    prompts = np.array([[1, 2, 3, 4]] * (4 if extras else 1), np.int32)
    tok, cache = eng.prime(prompts, extras)
    noise = eng.gumbel_noise(1, prompts.shape[0])
    eng.decode_segment(tok, cache, 1, noise)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            eng.decode_segment(tok, cache, 1, noise)
            if arch != "whisper_tiny":  # the pool step's per-row form
                pool = eng.model.init_slot_cache(3, 24, device=dev)
                eng.model.decode_step(eng.params, torch.ones((3, 1), dtype=torch.long,
                                                             device=dev), pool, rowwise=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "mamba2_2_7b"])
def test_recurrent_scheduler_equals_one_shot_on_card(arch, temperature):
    """The scheduler's graph pool step: every completion bitwise one-shot
    ``generate`` at B = 1 with the request's seed."""
    from repro_torch.serve import Request, Scheduler

    dev = _card()
    eng, _ = _family_engine(arch, dev, temperature=temperature)
    eng.sc = dataclasses.replace(eng.sc, max_len=48)
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(1, eng.cfg.vocab, int(rng.integers(3, 12))).astype(
        np.int32), max_new=int(rng.integers(4, 12)), seed=r) for r in range(5)]
    done = Scheduler(eng, slots=3, segment=4).run(reqs)
    for rid, r in enumerate(reqs):
        eng.sc = dataclasses.replace(eng.sc, seed=r.seed)
        want = eng.generate(r.prompt[None], max_new=r.max_new)["tokens"][0]
        np.testing.assert_array_equal(done[rid].tokens, want)


def _mesh_kernel_ranks(mesh, device, cases):
    """Each case's sharded B1 (column windows all-gathered) and B2 (window
    partials all-gathered, summed by the kernel's ordered sum) on this
    rank's windows, beside the single-device kernels on the whole packs."""
    from repro_torch.kernels.ops import (apply_fused_mlp_sharded, apply_row_packed_sharded,
                                         local_windows)

    out = {}
    for name, (x, w, wg, wu, wd, vd) in cases.items():
        x = x.to(device)
        p = pack_linear_rows(w, device=device, value_dtype=vd)
        g, u = (pack_linear_rows(m, device=device, value_dtype=vd) for m in (wg, wu))
        d = pack_linear_rows_t(wd, device=device, value_dtype=vd)
        local = [local_windows(q, mesh) for q in (p, g, u, d)]
        packed_mod.reset_launch_counts()
        row = apply_row_packed_sharded(x, local[0], mesh)
        mlp = apply_fused_mlp_sharded(x, *local[1:], mesh)
        counts = (packed_mod.vusa_packed_matmul.launches[vd],
                  packed_mod.vusa_fused_mlp_partials.launches[vd],
                  packed_mod.vusa_window_sum.launches["dense"])
        out[name] = (bool(torch.equal(row, apply_row_packed(x, p))),
                     bool(torch.equal(mlp, apply_fused_mlp(x, g, u, d))), counts)
    return out


@pytest.mark.gpu
def test_sharded_kernels_bitwise_on_card(tmp_path):
    """Two gloo ranks sharing the card: sharded B1 and gathered-partial B2
    bitwise the single-device kernels at vusa_edge's d_model and ff (768,
    3072: 24 ff windows) and a 251-window matrix, which pads to 252 over
    the two ranks; fp32 and int8 values, B = 1 and 4; each wrapper
    launched once a call."""
    _card()
    from repro_torch.kernels.build import build
    from repro_torch.launch.mesh import spawn

    build()  # the ranks only load the libraries
    rng = np.random.default_rng(11)
    cases = {}
    for vd in ("dense", "int8"):
        for b in (1, 4):
            cases[(vd, b)] = (torch.from_numpy(rng.standard_normal((b, 768)).astype(np.float32)),
                              _sparse(rng, 768, 128 * 251, 0.85), _sparse(rng, 768, 3072, 0.85),
                              _sparse(rng, 768, 3072, 0.85), _sparse(rng, 3072, 768, 0.85), vd)
    for rank in spawn(_mesh_kernel_ranks, 1, 2, "gloo", "cuda", str(tmp_path), args=(cases,)):
        for name, (row_ok, mlp_ok, counts) in rank.items():
            assert row_ok and mlp_ok, name
            assert counts == (1, 1, 1), name
