"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: skips without a CUDA device (the decision is taken inside
the test).  The file imports nothing of JAX, so it also runs on a machine
that has only the port:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Tolerance: 1e-4 of the largest output for fp32 and bf16 activations alike
(bf16 widens to fp32 exactly; both sides accumulate in fp32; int8/int4
values dequantize to the same fp32 products ``q * scale`` on both sides).
Row 0 of a B = 4 call must equal a B = 1 call bitwise.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ops import (
    apply_fused_mlp,
    apply_fused_mlp_ref,
    apply_row_packed,
    apply_row_packed_ref,
    pack_linear_rows,
    pack_linear_rows_t,
)
from repro_torch.kernels.vusa_packed import vusa_packed_matmul


def _sparse(rng, k, c, sparsity):
    w = rng.normal(size=(k, c)) * (rng.random((k, c)) >= sparsity)
    return w.astype(np.float32)


def _close(got, want, tol=1e-4):
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * max(float(want.float().abs().max()), 1.0), err


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
