"""Port vs reference: the quantized row pack and the quantized kernels' plain
versions.

The host-side format (``quantize_rows``, ``dequantize_rows``, the int4
nibble codec) must be byte-identical to ``repro.core.packing``: values,
positions, scales and ``dense_itemsize``.  On the CPU the port's wrappers run
their plain PyTorch versions; with int8 or int4 values they are held against
the JAX package's quantized Pallas kernels (``_qkernel``,
``_fused_mlp_qkernel``) run in interpret mode, over the cases
``tests/test_quantized_packed.py`` covers: sparsity 0/.85/.99, ragged K / C /
ff, B = 1, fp32 and bf16 activations, the all-zero matrix.  Tolerance 1e-5 of
the largest output: both sides rebuild the same fp32 values ``q * scale``
and accumulate in fp32, so only the summation order differs.

``tests/test_torch_cuda.py`` holds the CUDA kernels against the plain
versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as ref_packing
from repro.kernels import ops as ref_ops
from repro.kernels.vusa_packed import vusa_fused_mlp_matmul as ref_fused
from repro.kernels.vusa_packed import vusa_packed_matmul as ref_packed
from repro_torch.core import packing
from repro_torch.kernels import ops, ref
from repro_torch.kernels.vusa_packed import vusa_fused_mlp_matmul, vusa_packed_matmul

TOL = 1e-5
QDTYPES = ["int8", "int4"]


def _close(got, want, tol=TOL):
    """max |got - want| <= tol * max(|want|, 1)."""
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), err


def _sparse(rng, k, c, sparsity):
    w = rng.normal(size=(k, c)) * (rng.random((k, c)) >= sparsity)
    return w.astype(np.float32)


def _assert_same_qpack(got, want):
    assert (got.k, got.c, got.m, got.a, got.value_dtype) == (
        want.k, want.c, want.m, want.a, want.value_dtype)
    assert got.dense_itemsize == want.dense_itemsize
    for name in ("values", "row_positions", "scales"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


# ---------------------------------------------------------------------------
# the host-side format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", QDTYPES)
@pytest.mark.parametrize("sparsity", [0.0, 0.85, 0.99])
@pytest.mark.parametrize("k,c,m,a", [(64, 256, 128, 16), (48, 200, 128, 8), (33, 70, 32, 3)])
def test_quantize_rows_byte_identical(dt, sparsity, k, c, m, a):
    """a = 3 gives odd slot counts (int4 pads them to even); row 5 is all
    zero (scale 1.0)."""
    rng = np.random.default_rng(0)
    w = _sparse(rng, k, c, sparsity)
    w[5] = 0.0
    p = packing.pack_rows(w, m=m, a=a)
    got = packing.quantize_rows(p, dt)
    _assert_same_qpack(got, ref_packing.quantize_rows(ref_packing.pack_rows(w, m=m, a=a), dt))
    assert (got.scales[:, 5] == 1.0).all()
    back = packing.dequantize_rows(got)
    want = ref_packing.dequantize_rows(ref_packing.quantize_rows(p, dt))
    assert back.values.tobytes() == want.values.tobytes()
    assert back.row_positions.tobytes() == want.row_positions.tobytes()
    # the torch dequant twin rebuilds the same fp32 values
    tv = ref.dequantize_values(torch.from_numpy(got.values), torch.from_numpy(got.scales), dt)
    assert tv.numpy().tobytes() == back.values.tobytes()


@pytest.mark.parametrize("dt", QDTYPES)
def test_quantize_full_range(dt):
    """Every nonzero integer of the range appears: window 0 holds -qmax..-1
    and window 1 holds 1..qmax (times 0.25), so each window's scale is 0.25
    and the quantize-dequantize round trip is exact."""
    qmax = packing.QMAX[dt]
    ints = np.arange(1, qmax + 1, dtype=np.float32) * 0.25
    w = np.zeros((4, 256), np.float32)
    w[:, :qmax], w[:, 128:128 + qmax] = -ints, ints
    w[1] = -w[1]
    p = packing.pack_rows(w, a=4)
    got = packing.quantize_rows(p, dt)
    _assert_same_qpack(got, ref_packing.quantize_rows(ref_packing.pack_rows(w, a=4), dt))
    assert (got.scales == 0.25).all()
    raw = got.values if dt == "int8" else packing.unpack_nibbles(got.values)
    assert raw.min() == -qmax and raw.max() == qmax
    np.testing.assert_array_equal(packing.unpack_rows(packing.dequantize_rows(got)), w)


def test_nibbles_round_trip_all_bytes():
    b = np.arange(-128, 128, dtype=np.int8).reshape(2, 128)
    q = packing.unpack_nibbles(b)
    np.testing.assert_array_equal(q, ref_packing.unpack_nibbles(b))
    assert q.min() == -8 and q.max() == 7
    np.testing.assert_array_equal(packing.pack_nibbles(q), b)
    np.testing.assert_array_equal(packing.pack_nibbles(q), ref_packing.pack_nibbles(q))
    tq = ref.dequantize_values(torch.from_numpy(b), torch.ones(2), "int4")
    np.testing.assert_array_equal(tq.numpy(), q.astype(np.float32))
    with pytest.raises(ValueError, match="even"):
        packing.pack_nibbles(np.zeros((2, 3), np.int8))
    with pytest.raises(ValueError, match="value_dtype"):
        packing.quantize_rows(packing.pack_rows(np.eye(4, dtype=np.float32), m=4, a=1), "fp8")


@pytest.mark.parametrize("dt", ["dense", *QDTYPES])
def test_linear_pack_matches_reference(dt):
    """``pack_linear_rows`` of a bf16 tensor keeps its element size as
    ``dense_itemsize`` (the reference packs bf16 arrays as they are), so the
    byte ratio equals the reference's."""
    rng = np.random.default_rng(3)
    w = np.asarray(jnp.asarray(_sparse(rng, 64, 300, 0.85), jnp.bfloat16))
    want = ref_ops.pack_linear_rows(w, a=8, value_dtype=dt)
    got = ops.pack_linear_rows(torch.from_numpy(w.astype(np.float32)).bfloat16(), a=8,
                               value_dtype=dt)
    assert got.value_dtype == want.value_dtype and got.dense_itemsize == want.dense_itemsize
    assert got.byte_ratio == want.byte_ratio
    assert got.positions.numpy().tobytes() == np.asarray(want.positions).tobytes()
    if dt == "dense":
        assert got.values.dtype == torch.bfloat16 and got.scales is None
        np.testing.assert_array_equal(got.values.float().numpy(),
                                      np.asarray(want.values, np.float32))
    else:
        assert got.values.numpy().tobytes() == np.asarray(want.values).tobytes()
        assert got.scales.numpy().tobytes() == np.asarray(want.scales).tobytes()
    np.testing.assert_array_equal(ops.dequantize_linear_values(got).numpy(),
                                  np.asarray(ref_ops.dequantize_linear_values(want)))


# ---------------------------------------------------------------------------
# the quantized kernels' plain versions vs the Pallas kernels
# ---------------------------------------------------------------------------


def _jx(a):
    return jnp.asarray(a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy())


def _x(rng, b, k, xdtype):
    x = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32)).to(getattr(torch, xdtype))
    return x, jnp.asarray(x.float().numpy(), getattr(jnp, xdtype))


def _packed_both(x, jx, p, **kw):
    want = np.asarray(ref_packed(jx, _jx(p.values), _jx(p.positions), _jx(p.scales), m=p.m,
                                 interpret=True, value_dtype=p.value_dtype, **kw))
    got = vusa_packed_matmul(x, p.values, p.positions, p.scales, m=p.m,
                             value_dtype=p.value_dtype).numpy()
    return got, want


@pytest.mark.parametrize("dt", QDTYPES)
@pytest.mark.parametrize("sparsity", [0.0, 0.85, 0.99])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 4])
def test_quantized_packed_matmul_matches_pallas(dt, sparsity, xdtype, b):
    rng = np.random.default_rng(4)
    k, c = 96, 200  # C % m != 0
    w = _sparse(rng, k, c, sparsity)
    p = ops.pack_linear_rows(w, a=8, device="cpu", value_dtype=dt)
    x, jx = _x(rng, b, k, xdtype)
    got, want = _packed_both(x, jx, p)
    assert got.shape == (b, 2 * 128) and got.dtype == np.float32
    _close(got, want)
    qdq = packing.unpack_rows(packing.dequantize_rows(
        packing.quantize_rows(packing.pack_rows(w, a=8), dt)))
    np.testing.assert_allclose(got[:, :c], x.float().numpy() @ qdq, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dt", QDTYPES)
@pytest.mark.parametrize("k,c", [(48, 200), (100, 130), (64, 96)])
def test_quantized_packed_matmul_nondivisible(dt, k, c):
    """Ragged dims at m = 32, a = 4: padded lanes and nibble-padded slots are
    exact no-ops.  The Pallas kernel is the oracle (the reference's jnp
    oracle ignores m)."""
    rng = np.random.default_rng(5)
    p = ops.pack_linear_rows(_sparse(rng, k, c, 0.9), m=32, a=4, device="cpu", value_dtype=dt)
    x, jx = _x(rng, 2, k, "float32")
    got, want = _packed_both(x, jx, p)
    _close(got, want)


def test_quantized_all_zero_matrix_exact_zero():
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 32)).astype(np.float32))
    for dt in QDTYPES:
        p = ops.pack_linear_rows(np.zeros((32, 64), np.float32), m=32, a=4, device="cpu",
                                 value_dtype=dt)
        assert (p.scales == 1.0).all()
        y = ops.apply_row_packed(x, p)
        assert torch.equal(y, torch.zeros_like(y))


def _fused_case(rng, d, ff, sparsity, dt):
    wg, wu, wd = (_sparse(rng, *s, sparsity) for s in ((d, ff), (d, ff), (ff, d)))
    return (ops.pack_linear_rows(wg, a=8, device="cpu", value_dtype=dt),
            ops.pack_linear_rows(wu, a=8, device="cpu", value_dtype=dt),
            ops.pack_linear_rows_t(wd, a=8, device="cpu", value_dtype=dt))


def _fused_want(jx, pg, pu, pd):
    return np.asarray(ref_fused(
        jx, _jx(pg.values), _jx(pg.positions), _jx(pu.values), _jx(pu.positions),
        _jx(pd.values), _jx(pd.positions), _jx(pg.scales), _jx(pu.scales), _jx(pd.scales),
        k_blk=32, interpret=True, value_dtype=pg.value_dtype,
    ))


@pytest.mark.parametrize("dt", QDTYPES)
@pytest.mark.parametrize("sparsity", [0.0, 0.85, 0.99])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_quantized_fused_mlp_matches_pallas(dt, sparsity, xdtype):
    rng = np.random.default_rng(7)
    pg, pu, pd = _fused_case(rng, 64, 256, sparsity, dt)
    x, jx = _x(rng, 4, 64, xdtype)
    got = vusa_fused_mlp_matmul(
        x, pg.values, pg.positions, pu.values, pu.positions, pd.values, pd.positions,
        pg.scales, pu.scales, pd.scales, value_dtype=dt,
    ).numpy()
    _close(got, _fused_want(jx, pg, pu, pd))


@pytest.mark.parametrize("dt", QDTYPES)
@pytest.mark.parametrize("d,ff", [(48, 200), (100, 130), (64, 96)])
def test_quantized_fused_mlp_nondivisible(dt, d, ff):
    """Padded ff lanes are exact no-ops; B = 1."""
    rng = np.random.default_rng(8)
    pg, pu, pd = _fused_case(rng, d, ff, 0.9, dt)
    x, jx = _x(rng, 1, d, "float32")
    _close(ops.apply_fused_mlp(x, pg, pu, pd).numpy(), _fused_want(jx, pg, pu, pd))


@pytest.mark.parametrize("dt", QDTYPES)
def test_quantized_fused_mlp_zero_gate_exact_zero(dt):
    rng = np.random.default_rng(9)
    _, pu, pd = _fused_case(rng, 64, 128, 0.85, dt)
    pz = ops.pack_linear_rows(np.zeros((64, 128), np.float32), a=8, device="cpu",
                              value_dtype=dt)
    y = ops.apply_fused_mlp(torch.from_numpy(rng.normal(size=(2, 64)).astype(np.float32)),
                            pz, pu, pd)
    assert torch.equal(y, torch.zeros_like(y))


def test_wrappers_reject_bad_quantized_operands():
    rng = np.random.default_rng(10)
    p8 = ops.pack_linear_rows(_sparse(rng, 16, 64, 0.5), a=4, device="cpu", value_dtype="int8")
    p4 = ops.pack_linear_rows(_sparse(rng, 16, 64, 0.5), a=4, device="cpu", value_dtype="int4")
    x = torch.ones(2, 16)
    with pytest.raises(ValueError, match="need scales"):
        vusa_packed_matmul(x, p8.values, p8.positions, value_dtype="int8")
    with pytest.raises(ValueError, match="scales must be float32"):
        vusa_packed_matmul(x, p8.values, p8.positions, p8.scales[:, :-1], value_dtype="int8")
    with pytest.raises(ValueError, match="scales must be float32"):
        vusa_packed_matmul(x, p8.values, p8.positions, p8.scales.double(), value_dtype="int8")
    with pytest.raises(ValueError, match="do not decode"):
        vusa_packed_matmul(x, p8.values, p8.positions, p8.scales, value_dtype="int4")
    with pytest.raises(ValueError, match="do not decode"):
        vusa_packed_matmul(x, p4.values, p4.positions, p4.scales, value_dtype="int8")
    with pytest.raises(TypeError, match="int8 bytes"):
        vusa_packed_matmul(x, p8.values.float(), p8.positions, p8.scales, value_dtype="int8")
    with pytest.raises(ValueError, match="take no scales"):
        vusa_packed_matmul(x, p8.values.float(), p8.positions, p8.scales)
    with pytest.raises(ValueError, match="value_dtype"):
        vusa_packed_matmul(x, p8.values, p8.positions, p8.scales, value_dtype="fp8")
    with pytest.raises(ValueError, match="value dtypes differ"):
        ops.apply_fused_mlp(x, p8, p4, p8)
