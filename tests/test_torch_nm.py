"""Port vs reference: the N:M structured pack (S2TA's density-bound blocks,
the paper's structured-sparsity comparison arm) and the row pack's host
helpers.

``nm_mask`` / ``pack_rows_nm`` are numpy in both packages and must agree
byte for byte.  ``pack_linear_rows_nm`` is an ordinary row pack held to the
structure's slot bound; through the B1/B3 wrappers' plain versions (the CPU
route) it must equal ``x @ masked`` and the reference's Pallas kernel in
interpret mode within 1e-5 of the largest output (fp32 on both sides,
only the summation order differs, as in ``tests/test_torch_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as ref_packing
from repro.kernels import ops as ref_ops
from repro_torch.core import packing
from repro_torch.kernels.ops import (
    apply_row_packed,
    dequantize_linear_values,
    nm_slot_bound,
    pack_linear_rows_nm,
)

TOL = 1e-5


def _close(got, want, tol=TOL):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), err


def _weights(seed, k, c, sparsity):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, c)) * (rng.random((k, c)) >= sparsity)
    return w.astype(np.float32)


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.85])
@pytest.mark.parametrize("shape,nb", [((48, 256), (2, 4)), ((33, 203), (2, 4)),
                                      ((40, 130), (1, 4)), ((16, 77), (3, 8))])
def test_nm_mask_and_pack_byte_identical(sparsity, shape, nb):
    n, block = nb
    w = _weights(1, *shape, sparsity)
    mask = packing.nm_mask(w, n, block)
    np.testing.assert_array_equal(mask, ref_packing.nm_mask(w, n, block))
    full = (shape[1] // block) * block
    kept = mask[:, :full].reshape(shape[0], -1, block).sum(-1)
    assert kept.max() <= n and mask[:, full:].all()  # the tail is kept whole
    got = packing.pack_rows_nm(w, n=n, block=block, m=64, a=8)
    want = ref_packing.pack_rows_nm(w, n=n, block=block, m=64, a=8)
    for f in ("k", "c", "m", "a"):
        assert getattr(got, f) == getattr(want, f)
    assert got.values.tobytes() == want.values.tobytes()
    assert got.row_positions.tobytes() == want.row_positions.tobytes()
    with pytest.raises(ValueError):
        packing.nm_mask(w, 0, block)


@pytest.mark.parametrize("value_dtype", ["dense", "int8", "int4"])
@pytest.mark.parametrize("c", [256, 130])
def test_nm_slot_bound_holds(value_dtype, c):
    """The slot axis is the structure's bound whatever the data: a dense
    draw fills it, a sparser one is padded up to it with idle slots."""
    bound = nm_slot_bound(2, 4, 128, 16)
    assert bound == 64
    for sparsity in (0.0, 0.85):
        p = pack_linear_rows_nm(_weights(2, 32, c, sparsity), device="cpu",
                                value_dtype=value_dtype)
        assert p.slots == bound and p.positions.shape == (-(-c // 128), 32, bound)
        nib = 2 if value_dtype == "int4" else 1
        assert p.values.shape[-1] * nib == bound
        per_row = (p.positions >= 0).sum(-1)
        assert int(per_row.max()) <= 2 * 128 // 4


def test_nm_slot_bound_refuses_an_overflowing_tail():
    """The last C % block columns stay whole (``nm_mask``): in a window of
    full blocks they push a row past the bound, which the pack refuses."""
    w = _weights(3, 8, 255, 0.0)  # window 1: 31 full blocks + 3 whole columns
    with pytest.raises(ValueError, match="above its bound"):
        pack_linear_rows_nm(w, device="cpu")


@pytest.mark.parametrize("value_dtype", ["dense", "int8", "int4"])
@pytest.mark.parametrize("b", [1, 5])
def test_nm_pack_through_plain_kernels_matches(value_dtype, b):
    w = _weights(4, 96, 200, 0.3)
    x = np.random.default_rng(5).normal(size=(b, 96)).astype(np.float32)
    p = pack_linear_rows_nm(torch.from_numpy(w), device="cpu", value_dtype=value_dtype)
    got = apply_row_packed(torch.from_numpy(x), p).numpy()
    masked = np.where(packing.nm_mask(w, 2, 4), w, 0)
    if value_dtype == "dense":
        _close(got, x @ masked)
    # the reference's pack and its Pallas kernel in interpret mode
    ref = ref_ops.pack_linear_rows_nm(w, value_dtype=value_dtype)
    want = np.asarray(ref_ops.apply_row_packed(jnp.asarray(x), ref, interpret=True))
    _close(got, want)
    # the same values and positions slot for slot, then the bound's idle slots
    s = ref.positions.shape[-1]
    np.testing.assert_array_equal(p.positions[..., :s].numpy(), np.asarray(ref.positions))
    assert (p.positions[..., s:] == -1).all()
    np.testing.assert_array_equal(dequantize_linear_values(p)[..., :s].numpy(),
                                  np.asarray(ref_ops.dequantize_linear_values(ref)))


@pytest.mark.parametrize("sparsity", [0.0, 0.85])
def test_byte_ratio_and_quantized_slots_equal_reference(sparsity):
    w = _weights(6, 40, 300, sparsity)
    got, want = packing.pack_rows(w, m=128, a=16), ref_packing.pack_rows(w, m=128, a=16)
    for vb in (1, 2, 4):
        assert got.byte_ratio(vb) == want.byte_ratio(vb)
    assert got.byte_ratio() == want.byte_ratio()
    for vdt in ("int8", "int4"):
        q, rq = packing.quantize_rows(got, vdt), ref_packing.quantize_rows(want, vdt)
        assert q.slots == rq.slots and q.n_jobs == rq.n_jobs
