"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: skips without a CUDA device (the decision is taken inside
the test).  The file imports nothing of JAX, so it also runs on a machine
that has only the port:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Tolerance: 1e-4 of the largest output for fp32 and bf16 activations alike
(bf16 widens to fp32 exactly; both sides accumulate in fp32; int8/int4
values dequantize to the same fp32 products ``q * scale`` on both sides).
Row 0 of a B = 4 call must equal a B = 1 call bitwise.  The block-VUSA
kernel returns ``x.dtype``: with bf16 ``x`` both sides round their fp32 sum
to bf16 once, so they may part by one bf16 step (2**-7 of the value) on
top of the 1e-4.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
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


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,k,c,sp,m_blk,a_blk",
    [
        (8, 256, 384, 0.9, 32, 8),
        (4, 100, 130, 0.85, 32, 8),
        (16, 512, 256, 0.0, 32, 8),
        (2, 64, 128, 0.99, 16, 8),
        (1, 147, 64, 0.85, 32, 8),
        (8450, 576, 200, 0.85, 32, 8),  # BM = 64 blocks, a ragged last one
    ],
)
def test_vusa_spmm_matches_plain_on_card(b, k, c, sp, m_blk, a_blk):
    """B5 vs its plain version: the shapes of tests/test_kernels.py, B = 1,
    C % 128 != 0, an all-zero window, B large enough for BM = 64 blocks;
    fp32 and bf16 x; rows independent of B; a NaN in x[:, 0] reaches the
    same outputs as in the plain version (padding rows point at row 0 and
    are multiplied)."""
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
    _close(apply_packed(x, p), x @ torch.from_numpy(w).to(dev), 1e-3)
    xn = x.clone()
    xn[:, 0] = float("nan")
    xp = torch.nn.functional.pad(xn, (0, p.k_padded - k))
    got, want = vusa_spmm(xp, p.values, p.row_idx), ref.vusa_spmm_ref(xp, p.values, p.row_idx)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize(
    "m,k,n", [(8, 128, 128), (128, 256, 384), (16, 64, 256), (49, 9, 32), (8450, 256, 384)]
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_matmul_matches_plain_on_card(m, k, n, dtype):
    """B6 vs its plain version at the shapes of tests/test_kernels.py and
    ragged ones (M = 49 and 8450 take bm = 1, K = 9, N = 32; 8450 rows run
    BM = 64 blocks), fp32 and bf16 operands; rows independent of M."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dev, dtype)
    got = matmul(x, w)
    assert got.shape == (m, n) and got.dtype == torch.float32
    _close(got, ref.dense_matmul_ref(x, w))
    assert torch.equal(dense_matmul(x[:1], w)[0], got[0])
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
