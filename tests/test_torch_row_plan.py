"""The launch plan of the row-packed matmul (B1/B3) and its order of
operations, on the CPU.

``kernels/row_plan.py`` cuts the reduction over a pack's K rows into
ordered slices of 64 rows (one slice for K <= 64) and the
``vusa_packed_matmul`` wrapper passes that plan to ``csrc/vusa_packed.cu``,
with an fp32 workspace for the slices' partials when there is more than
one.  The wrapper's CUDA path is driven here with a recording stand-in for
the kernel library (operands stay on the CPU and nothing is launched), so
the plan, the workspace and the row chunks it hands to C are checked
without a card: the same at B = 1, 4, 8 and 9, one launch and no workspace
for one slice, and CUDA launches as ``row_plan.cuda_launches`` counts them.

``ref.vusa_packed_sliced_ref`` emulates the kernel's order of operations
(slices of 64 rows in order; per slice, four parts of each 32-row chunk
accumulated apart in ascending k and added in order at the slice's end).  It is held
within 1e-5 of the largest output of ``ref.vusa_packed_ref`` for fp32, bf16,
int8 and int4 values, bitwise independent of B, and within 1e-5 of the
JAX package's Pallas ``vusa_packed_matmul`` in interpret mode (at m != 128
only the Pallas kernel is the oracle: the JAX package's jnp reference
assumes m = 128).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.vusa_packed import vusa_packed_matmul as pallas_packed
from repro_torch.kernels import ops, ref, row_plan
from repro_torch.kernels import vusa_packed as packed_mod

TOL = 1e-5
KINDS = ("float32", "bfloat16", "int8", "int4")


class _Recorder:
    """Stands in for the kernel library: records each ``vusa_packed_matmul``
    call's plan, rows and pointers, and the wrapper's workspace; launches
    nothing."""

    def __init__(self):
        self.calls = []
        self.workspace = []

    def vusa_packed_matmul(self, *args):
        # x, x_bf16, values, kind, scales, positions, out, part, B, K, T, S, m, slices, rows, stream
        self.calls.append({"x": args[0], "kind": args[3], "out": args[6], "B": args[8],
                           "K": args[9], "T": args[10], "S": args[11], "m": args[12],
                           "plan": row_plan.RowPlan(*args[13:15])})
        return 0


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    empty = torch.empty

    def spy_empty(*shape, **kw):
        t = empty(*shape, **kw)
        if t.ndim == 1:  # the workspace is the wrapper's only 1-D allocation
            rec.workspace.append(t.numel() * t.element_size())
        return t

    monkeypatch.setattr(packed_mod, "_lib", lambda: rec)
    monkeypatch.setattr(packed_mod, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(packed_mod, "_stream", lambda device: 0)
    monkeypatch.setattr(torch, "empty", spy_empty)
    return rec


def _operands(t, k, s, value_dtype):
    """Uninitialised (T, K, S) pack operands of ``value_dtype``."""
    positions = torch.empty((t, k, s), dtype=torch.int8)
    if value_dtype == "dense":
        return torch.empty((t, k, s)), positions, None
    nib = 2 if value_dtype == "int4" else 1
    return torch.empty((t, k, s // nib), dtype=torch.int8), positions, torch.empty((t, k))


@pytest.mark.parametrize("k,t", [(768, 6), (1000, 6), (3072, 6), (768, 250)])
@pytest.mark.parametrize("value_dtype,kind", [("dense", 0), ("int8", 2), ("int4", 3)])
def test_plan_independent_of_batch(recorder, k, t, value_dtype, kind):
    """At B = 1, 4, 8 and 9 the wrapper passes one call with the plan of
    ``row_plan(K)`` and a workspace of slices * B * T*m * 4 bytes: the plan
    never sees B."""
    values, positions, scales = _operands(t, k, 48, value_dtype)
    plans = []
    for b in (1, 4, 8, 9):
        recorder.calls.clear()
        recorder.workspace.clear()
        out = packed_mod.vusa_packed_matmul(torch.empty((b, k)), values, positions, scales,
                                            value_dtype=value_dtype)
        assert out.shape == (b, t * 128)
        (call,) = recorder.calls
        assert (call["B"], call["K"], call["T"], call["S"], call["m"], call["kind"]) == (
            b, k, t, 48, 128, kind)
        p = call["plan"]
        assert recorder.workspace == [row_plan.workspace_bytes(p, b, t * 128)]
        assert recorder.workspace[0] == p.slices * b * t * 128 * 4
        assert row_plan.cuda_launches(p, b, t * 128) == 2
        plans.append(p)
    assert plans == [row_plan.row_plan(k)] * 4
    assert plans[0] == row_plan.RowPlan(slices=-(-k // 64), rows=64)


@pytest.mark.parametrize("k", [1, 17, 64])
def test_one_slice_is_one_launch_without_workspace(recorder, k):
    """K <= 64 rows is one slice: one CUDA launch, which writes the output,
    and no workspace (an empty one is allocated, and C ignores it)."""
    values, positions, _ = _operands(2, k, 16, "dense")
    packed_mod.vusa_packed_matmul(torch.empty((4, k)), values, positions)
    p = row_plan.row_plan(k)
    assert p.slices == 1 and [c["plan"] for c in recorder.calls] == [p]
    assert recorder.workspace == [0] and row_plan.workspace_bytes(p, 4, 256) == 0
    assert row_plan.cuda_launches(p, 4, 256) == 1


@pytest.mark.parametrize(
    "k,slices", [(0, 1), (1, 1), (64, 1), (65, 2), (128, 2), (200, 4), (768, 12), (1000, 16),
                 (3072, 48)])
def test_slices_follow_reduction_length(k, slices):
    """ceil(K / 64) ordered slices, at least one; two CUDA launches per
    call once K is split, one before; none for an empty output."""
    p = row_plan.row_plan(k)
    assert p == row_plan.RowPlan(slices=slices, rows=64)
    assert row_plan.cuda_launches(p, 4, 768) == (1 if slices == 1 else 2)
    assert row_plan.cuda_launches(p, 0, 768) == 0 and row_plan.cuda_launches(p, 4, 0) == 0


@pytest.mark.parametrize("rows", [8, 20, 33])
def test_many_rows_run_in_chunks_that_bound_the_workspace(recorder, rows):
    """K = 3072 (48 slices) and the head's 32000 columns: 6,144,000 bytes of
    partials a row, so 8 rows (one batch tile) fill the 64 MiB workspace.
    The wrapper passes consecutive chunks of at most 8 rows that cover the
    batch, with x and out offset to each chunk's first row, one plan and
    one workspace; one counted launch, two CUDA launches per chunk."""
    k, t = 3072, 250
    values, positions, _ = _operands(t, k, 2, "dense")
    x = torch.empty((rows, k))
    packed_mod.reset_launch_counts()
    out = packed_mod.vusa_packed_matmul(x, values, positions)
    p = row_plan.row_plan(k)
    chunks = row_plan.row_chunks(p, rows, t * 128)
    assert [r1 - r0 for r0, r1 in chunks][:-1] == [8] * (len(chunks) - 1)
    assert chunks[0][0] == 0 and chunks[-1][1] == rows
    assert [(c["x"], c["out"], c["B"]) for c in recorder.calls] == [
        (x.data_ptr() + r0 * k * 4, out.data_ptr() + r0 * t * 128 * 4, r1 - r0)
        for r0, r1 in chunks]
    assert {c["plan"] for c in recorder.calls} == {p}
    assert recorder.workspace == [48 * 8 * t * 128 * 4]
    assert recorder.workspace[0] <= row_plan.WORKSPACE_BYTES
    assert row_plan.cuda_launches(p, rows, t * 128) == 2 * len(chunks) == 2 * -(-rows // 8)
    assert packed_mod.vusa_packed_matmul.launches["dense"] == 1


def _pack(rng, k, c, kind, m=128, a=16):
    w = (rng.normal(size=(k, c)) * (rng.random((k, c)) >= 0.85)).astype(np.float32)
    w[5] = 0.0  # an all-zero row
    vd = kind if kind in ("int8", "int4") else "dense"
    p = ops.pack_linear_rows(w, m=m, a=a, device="cpu", value_dtype=vd)
    if kind == "bfloat16":
        p = dataclasses.replace(p, values=p.values.to(torch.bfloat16))
    return p, vd


def _close(got, want, tol=TOL):
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * max(float(want.float().abs().max()), 1.0), err


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k,a", [(768, 16), (1000, 3), (200, 16)])
def test_sliced_order_matches_plain_and_is_batch_invariant(kind, k, a):
    """The kernel's order of operations within 1e-5 of the plain version,
    for every value kind, and bitwise the same row whatever B holds."""
    rng = np.random.default_rng(11)
    p, vd = _pack(rng, k, 300, kind, a=a)
    x = torch.from_numpy(rng.normal(size=(9, k)).astype(np.float32))
    args = (p.values, p.positions, p.scales)
    got = ref.vusa_packed_sliced_ref(x, *args, m=p.m, value_dtype=vd)
    _close(got, ref.vusa_packed_ref(x, *args, m=p.m, value_dtype=vd))
    for b in (1, 4):
        assert torch.equal(ref.vusa_packed_sliced_ref(x[:b], *args, m=p.m, value_dtype=vd),
                           got[:b])
    assert torch.equal(ref.vusa_packed_sliced_ref(x[4:], *args, m=p.m, value_dtype=vd), got[4:])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k,m", [(200, 128), (1000, 128), (200, 64)])
def test_sliced_order_matches_pallas(kind, k, m):
    """The kernel's order of operations within 1e-5 of the Pallas
    ``vusa_packed_matmul`` in interpret mode (its ``_kernel`` and
    ``_qkernel``), at m = 128 and m = 64."""
    rng = np.random.default_rng(12)
    p, vd = _pack(rng, k, 200, kind, m=m)
    x = rng.normal(size=(4, k)).astype(np.float32)
    if kind == "bfloat16":
        vals = jnp.asarray(p.values.float().numpy(), jnp.bfloat16)
    else:
        vals = jnp.asarray(p.values.numpy())
    scales = None if p.scales is None else jnp.asarray(p.scales.numpy())
    want = np.array(pallas_packed(jnp.asarray(x), vals, jnp.asarray(p.positions.numpy()), scales,
                                    m=m, k_blk=k, interpret=True, value_dtype=vd))
    got = ref.vusa_packed_sliced_ref(torch.from_numpy(x), p.values, p.positions, p.scales, m=m,
                                     value_dtype=vd)
    assert got.shape == want.shape
    _close(got, torch.from_numpy(want))
