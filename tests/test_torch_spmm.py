"""Port vs reference: the block-VUSA product (B5) and the dense baseline (B6).

The packs must be byte-identical to ``repro.core.packing``'s.  On the CPU
the port's wrappers run their plain versions; they are held against the
reference's Pallas kernels in interpret mode, as ``tests/test_kernels.py``
runs them, within 1e-5 of the largest output (both sides widen to fp32;
only the summation order differs), and against ``x @ w`` within 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as ref_packing
from repro.core.workloads import resnet18_gemms
from repro.kernels import ops as ref_ops
from repro_torch.convert import packed_linear_from_numpy
from repro_torch.core import packing
from repro_torch.kernels import ops

# (b, k, c, sparsity, m_blk, a_blk): the shapes of tests/test_kernels.py
SPMM_SHAPES = [
    (8, 256, 384, 0.9, 32, 8),
    (4, 100, 130, 0.85, 32, 8),  # K and C padded
    (16, 512, 256, 0.0, 32, 8),
    (2, 64, 128, 0.99, 16, 8),
]


def _sparse(rng, k, c, sparsity):
    w = rng.normal(size=(k, c)) * (rng.random((k, c)) > sparsity)
    return w.astype(np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()) if want.size else 0.0, 1.0), err


def _tile_pad(d):
    """``d`` padded to the reference ``dense_matmul``'s contract."""
    return d if d <= 128 or d % 128 == 0 else -(-d // 128) * 128


def _assert_same_blocks(got, want):
    assert (got.k, got.c, got.m_blk, got.a_blk, got.tile_n) == \
        (want.k, want.c, want.m_blk, want.a_blk, want.tile_n)
    assert got.values.dtype == want.values.dtype and got.row_idx.dtype == want.row_idx.dtype
    assert got.values.shape == want.values.shape
    assert got.values.tobytes() == want.values.tobytes()
    assert got.row_idx.tobytes() == want.row_idx.tobytes()
    assert got.compression == want.compression
    assert got.virtual_growth == want.virtual_growth


@pytest.mark.parametrize(
    "k,c,sparsity,m_blk,a_blk",
    [(k, c, sp, mb, ab) for _, k, c, sp, mb, ab in SPMM_SHAPES]
    + [(147, 64, 0.85, 32, 8),  # K padded only (ResNet-18 conv0)
       (256, 200, 0.85, 32, 8),  # C padded only
       (96, 256, 0.5, 32, 8)],  # an all-zero window, a tile with fewer jobs
)
def test_pack_blocks_byte_identical(k, c, sparsity, m_blk, a_blk):
    rng = np.random.default_rng(0)
    w = _sparse(rng, k, c, sparsity)
    if k == 96:
        w[32:64] = 0.0
        w[:20, 128:] = 0.0
    w = np.pad(w, ((0, (-k) % m_blk), (0, (-c) % 128)))  # as pack_linear pads
    got = packing.pack_blocks(w, m_blk, a_blk, 128)
    _assert_same_blocks(got, ref_packing.pack_blocks(w, m_blk, a_blk, 128))
    np.testing.assert_array_equal(packing.unpack_blocks(got), w)
    with pytest.raises(AssertionError):
        packing.pack_blocks(w[:-1], m_blk, a_blk, 128)


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.85])
def test_pack_exact_byte_identical(sparsity):
    rng = np.random.default_rng(1)
    w = _sparse(rng, 13, 40, sparsity)
    got, want = packing.pack_exact(w, 3, 6, 3), ref_packing.pack_exact(w, 3, 6, 3)
    assert (got.N, got.M, got.A, got.rows, got.cols, got.n_jobs) == \
        (want.N, want.M, want.A, want.rows, want.cols, want.n_jobs)
    for tile, ref_tile in zip(got.tiles, want.tiles, strict=True):
        for (job, vals, pos), (rjob, rvals, rpos) in zip(tile, ref_tile, strict=True):
            assert (job.start, job.width) == (rjob.start, rjob.width)
            assert vals.dtype == rvals.dtype and vals.tobytes() == rvals.tobytes()
            assert pos.dtype == rpos.dtype and pos.tobytes() == rpos.tobytes()
    np.testing.assert_array_equal(packing.unpack_exact(got), ref_packing.unpack_exact(want))
    np.testing.assert_array_equal(packing.unpack_exact(got), w)


@pytest.mark.parametrize("b,k,c,sparsity,m_blk,a_blk", SPMM_SHAPES)
def test_apply_packed_matches_reference(b, k, c, sparsity, m_blk, a_blk):
    """B5's plain version against the Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(1)
    w = _sparse(rng, k, c, sparsity)
    x = rng.normal(size=(b, k)).astype(np.float32)
    p = ops.pack_linear(w, m_blk, a_blk, 128, device="cpu")
    rp = ref_ops.pack_linear(w, m_blk, a_blk, 128)
    assert (p.k, p.c, p.k_padded) == (rp.k, rp.c, rp.k_padded)
    np.testing.assert_array_equal(p.values.numpy(), np.asarray(rp.values))
    np.testing.assert_array_equal(p.row_idx.numpy(), np.asarray(rp.row_idx))
    assert p.compression == rp.compression
    got = ops.apply_packed(torch.from_numpy(x), p)
    assert got.shape == (b, c) and got.dtype == torch.float32
    _close(got, ref_ops.apply_packed(jnp.asarray(x), rp), 1e-5)
    _close(got, x @ w, 1e-3)
    _close(ops.apply_packed_ref(torch.from_numpy(x), p), got, 1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)  # output rounds to bf16 once
    yb = ops.apply_packed(xb, p)
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb, ops.apply_packed(xb.float(), p).to(torch.bfloat16))


@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (128, 256, 384), (16, 64, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_reference(m, k, n, dtype):
    """B6's plain version against the Pallas kernel (interpret mode); bf16
    operands widen to fp32 on both sides, so 1e-5 holds for both dtypes."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16,
                                                                          jnp.bfloat16)
    got = ops.matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    want = ref_ops.matmul(jnp.asarray(x, dtype=jdt), jnp.asarray(w, dtype=jdt))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("m,k,n", [(8, 147, 128), (8, 128, 1000), (8, 576, 64)])
def test_matmul_rejects_what_reference_rejects(m, k, n):
    """K or N above 128 and not a multiple of it: both raise."""
    x, w = np.ones((m, k), np.float32), np.ones((k, n), np.float32)
    with pytest.raises(AssertionError):
        ref_ops.matmul(jnp.asarray(x), jnp.asarray(w))
    with pytest.raises(ValueError):
        ops.matmul(torch.from_numpy(x), torch.from_numpy(w))


def test_packed_linear_from_numpy():
    """A reference pack carried across computes what the port's own pack of
    the same weights computes."""
    rng = np.random.default_rng(3)
    w = _sparse(rng, 100, 130, 0.85)
    x = torch.from_numpy(rng.normal(size=(4, 100)).astype(np.float32))
    rp = ref_ops.pack_linear(w)
    p = packed_linear_from_numpy(np.asarray(rp.values), np.asarray(rp.row_idx), rp.k, rp.c,
                                 rp.k_padded, device="cpu")
    own = ops.pack_linear(w, device="cpu")
    assert torch.equal(p.values, own.values) and torch.equal(p.row_idx, own.row_idx)
    assert p.row_idx.dtype == torch.int32 and p.compression == rp.compression
    assert torch.equal(ops.apply_packed(x, p), ops.apply_packed(x, own))
    bad = np.asarray(rp.row_idx).copy()
    bad[0, 0, 0] = rp.k_padded
    with pytest.raises(ValueError):
        packed_linear_from_numpy(np.asarray(rp.values), bad, rp.k, rp.c, rp.k_padded, "cpu")


@pytest.mark.parametrize("i", [0, 1, 2])
def test_paper_slice_first_resnet18_gemms(i):
    """The slice as a whole on the first three ResNet-18 GEMMs at their
    published K and C (B cut to 64 rows), 85 % magnitude-pruned: B5 through
    ``pack_linear``/``apply_packed`` and B6 through ``matmul`` on operands
    padded to its tile contract, in the port and in the reference."""
    g = resnet18_gemms()[i]
    rng = np.random.default_rng(i)
    w = rng.normal(size=(g.K, g.C))
    w = (w * (np.abs(w) > np.quantile(np.abs(w), 0.85))).astype(np.float32)
    x = rng.normal(size=(64, g.K)).astype(np.float32)
    exact = x @ w

    p = ops.pack_linear(w, 32, 8, 128, device="cpu")
    y5 = ops.apply_packed(torch.from_numpy(x), p)
    _close(y5, ref_ops.apply_packed(jnp.asarray(x), ref_ops.pack_linear(w, 32, 8, 128)), 1e-5)
    _close(y5, exact, 1e-3)

    kp, np_ = _tile_pad(g.K), _tile_pad(g.C)
    xp = np.pad(x, ((0, 0), (0, kp - g.K)))
    wp = np.pad(w, ((0, kp - g.K), (0, np_ - g.C)))
    y6 = ops.matmul(torch.from_numpy(xp), torch.from_numpy(wp))
    _close(y6, ref_ops.matmul(jnp.asarray(xp), jnp.asarray(wp)), 1e-5)
    _close(y6[:, : g.C], exact, 1e-3)
