"""Port vs reference: the two packed-matmul kernels.

On the CPU the port's wrappers run their plain PyTorch versions
(``repro_torch.kernels.ref``); they are held against the JAX package's
Pallas kernels run in interpret mode, over the cases
``tests/test_packed_weights.py`` covers: sparsity 0/.85/.99, fp32 and bf16
values, ragged K / C / ff, all-zero rows.  Tolerance 1e-5 of the largest
output magnitude: both sides compute in fp32 from the same (bf16-rounded)
values and only the summation order differs, so the rounding error scales
with the terms summed, not with an output that cancels to near zero.

``tests/test_torch_cuda.py`` holds the CUDA kernels against the plain
versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.vusa_packed import vusa_fused_mlp_matmul as ref_fused
from repro.kernels.vusa_packed import vusa_packed_matmul as ref_packed
from repro_torch.core.packing import pack_rows, pack_rows_t
from repro_torch.kernels.ops import (
    apply_fused_mlp,
    apply_row_packed,
    pack_linear_rows,
    pack_linear_rows_t,
)
from repro_torch.kernels.vusa_packed import vusa_fused_mlp_matmul, vusa_packed_matmul

TOL = 1e-5


def _close(got, want, tol=TOL):
    """max |got - want| <= tol * max(|want|, 1)."""
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), err


def _sparse(rng, k, c, sparsity):
    w = rng.normal(size=(k, c)) * (rng.random((k, c)) >= sparsity)
    return w.astype(np.float32)


def _round(w, dtype):
    """Values as the kernel sees them: fp32, or rounded to bf16 (as fp32)."""
    return w if dtype == "float32" else np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32)


def _jx(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _tt(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


@pytest.mark.parametrize("sparsity", [0.0, 0.85, 0.99])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 4])
def test_packed_matmul_matches_pallas(sparsity, dtype, b):
    rng = np.random.default_rng(0)
    k, c, m = 96, 200, 128  # C % m != 0
    w = _round(_sparse(rng, k, c, sparsity), dtype)
    p = pack_rows(w, m=m, a=8)
    x = rng.normal(size=(b, k)).astype(np.float32)
    want = np.asarray(ref_packed(
        jnp.asarray(x), _jx(p.values, dtype), jnp.asarray(p.row_positions), m=m, interpret=True
    ))
    got = vusa_packed_matmul(
        torch.from_numpy(x), _tt(p.values, dtype), torch.from_numpy(p.row_positions), m=m
    ).numpy()
    assert got.shape == (b, 2 * m) and got.dtype == np.float32
    _close(got, want)
    np.testing.assert_allclose(got[:, :c], x @ w, rtol=1e-4, atol=1e-4)


def test_packed_matmul_all_zero_rows_and_small_window():
    rng = np.random.default_rng(1)
    w = _sparse(rng, 40, 70, 0.8)
    w[5:25] = 0.0
    w[:, 10:30] = 0.0
    p = pack_rows(w, m=32, a=4)
    x = rng.normal(size=(3, 40)).astype(np.float32)
    want = np.asarray(ref_packed(
        jnp.asarray(x), jnp.asarray(p.values), jnp.asarray(p.row_positions), m=32, interpret=True
    ))
    got = vusa_packed_matmul(
        torch.from_numpy(x), torch.from_numpy(p.values), torch.from_numpy(p.row_positions), m=32
    ).numpy()
    _close(got, want)


def _fused_case(rng, d, ff, sparsity, dtype):
    wg, wu, wd = (_round(_sparse(rng, *s, sparsity), dtype) for s in ((d, ff), (d, ff), (ff, d)))
    return wg, wu, wd, pack_rows(wg, a=8), pack_rows(wu, a=8), pack_rows_t(wd, a=8)


def _fused_both(x, pg, pu, pd, dtype):
    want = np.asarray(ref_fused(
        jnp.asarray(x),
        _jx(pg.values, dtype), jnp.asarray(pg.row_positions),
        _jx(pu.values, dtype), jnp.asarray(pu.row_positions),
        _jx(pd.values, dtype), jnp.asarray(pd.row_positions),
        k_blk=32, interpret=True,
    ))
    got = vusa_fused_mlp_matmul(
        torch.from_numpy(x),
        _tt(pg.values, dtype), torch.from_numpy(pg.row_positions),
        _tt(pu.values, dtype), torch.from_numpy(pu.row_positions),
        _tt(pd.values, dtype), torch.from_numpy(pd.row_positions),
    ).numpy()
    return got, want


@pytest.mark.parametrize("sparsity", [0.0, 0.85, 0.99])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_matches_pallas(sparsity, dtype):
    rng = np.random.default_rng(2)
    wg, wu, wd, pg, pu, pd = _fused_case(rng, 64, 256, sparsity, dtype)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    got, want = _fused_both(x, pg, pu, pd, dtype)
    _close(got, want)
    h = torch.nn.functional.silu(torch.from_numpy(x @ wg)).numpy() * (x @ wu)
    np.testing.assert_allclose(got, h @ wd, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("d,ff", [(48, 200), (100, 130), (64, 96)])
def test_fused_mlp_nondivisible_shapes(d, ff):
    """Padded ff lanes are exact no-ops."""
    rng = np.random.default_rng(3)
    *_, pg, pu, pd = _fused_case(rng, d, ff, 0.9, "float32")
    x = rng.normal(size=(2, d)).astype(np.float32)
    got, want = _fused_both(x, pg, pu, pd, "float32")
    _close(got, want)


def test_fused_mlp_all_zero_rows():
    rng = np.random.default_rng(4)
    d, ff = 64, 128
    wg, wu, wd = _sparse(rng, d, ff, 0.85), _sparse(rng, d, ff, 0.85), _sparse(rng, ff, d, 0.85)
    wg[10:30] = 0.0
    wu[:, 40:80] = 0.0
    wd[5:60] = 0.0
    x = rng.normal(size=(2, d)).astype(np.float32)
    got, want = _fused_both(x, pack_rows(wg, a=8), pack_rows(wu, a=8), pack_rows_t(wd, a=8),
                            "float32")
    _close(got, want)
    # fully-zero gate: the whole MLP output is exactly zero
    pz = pack_linear_rows(np.zeros_like(wg), a=8, device="cpu")
    y = apply_fused_mlp(torch.from_numpy(x), pz, pack_linear_rows(wu, a=8, device="cpu"),
                        pack_linear_rows_t(wd, a=8, device="cpu"))
    assert torch.equal(y, torch.zeros_like(y))


def test_wrappers_reject_bad_operands():
    p = pack_linear_rows(np.eye(8, dtype=np.float32), a=4, device="cpu")
    x = torch.ones(2, 8)
    with pytest.raises(TypeError, match="int8"):
        vusa_packed_matmul(x, p.values, p.positions.to(torch.int32))
    with pytest.raises(ValueError, match="reduction dim"):
        vusa_packed_matmul(torch.ones(2, 9), p.values, p.positions)
    with pytest.raises(ValueError, match="outside"):
        vusa_packed_matmul(x, p.values, p.positions, m=129)
    torch.testing.assert_close(apply_row_packed(x, p), x, rtol=0, atol=0)
