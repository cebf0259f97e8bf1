"""The launch plan of the fused SwiGLU MLP (B2/B4) and its order of
operations, on the CPU.

``kernels/mlp_plan.py`` cuts the K gate/up rows and the D down rows of a
fused MLP into ordered slices over the eight blocks of a thread block
cluster (whole 32-row chunks, from K and from D alone), and the
``vusa_fused_mlp_matmul`` wrapper passes that plan to
``csrc/vusa_packed.cu`` with an fp32 scratch for the (T, B, D) window
partials.  The wrapper's CUDA path is driven here with a recording stand-in
for the kernel library (operands stay on the CPU and nothing is launched),
so the plan and the scratch it hands to C are checked without a card: the
same plan at B = 1, 4, 8 and 9, a scratch of T * B * D fp32, and CUDA
launches as ``mlp_plan.cuda_launches`` counts them.

``ref.vusa_fused_mlp_sliced_ref`` emulates the kernel's order of
operations (gate and up: per slice four parts of each 32-row chunk in
ascending k, added in part order, the slices in rank order; h = g / (1 +
exp(-g)) * u; down: each row's slots in slot order; the windows in order).
It is held within 1e-5 of the largest output of ``ref.vusa_fused_mlp_ref``
for fp32, bf16, int8 and int4 values at a = 16 and a = 3 with K and D off
the slice size and ff % m != 0, bitwise independent of B, and within 1e-5
of the JAX package's Pallas ``vusa_fused_mlp_matmul`` in interpret mode (at
m != 128 only the Pallas kernel is the oracle: the JAX package's jnp
reference assumes m = 128).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.vusa_packed import vusa_fused_mlp_matmul as pallas_fused
from repro_torch.kernels import mlp_plan, ops, ref
from repro_torch.kernels import vusa_packed as packed_mod

TOL = 1e-5
KINDS = ("float32", "bfloat16", "int8", "int4")


class _Recorder:
    """Stands in for the kernel library: records each
    ``vusa_fused_mlp_matmul`` call's shapes, plan and pointers; launches
    nothing."""

    def __init__(self):
        self.calls = []
        self.scratch = []

    def vusa_fused_mlp_matmul(self, *args):
        # x, x_bf16, kind, gv, gs, gp, Sg, uv, us, up, Su, dv, ds, dp, Sd, partial, out,
        # B, K, D, T, m, cluster, rows, down_rows, stream
        self.calls.append({"kind": args[2], "S": (args[6], args[10], args[14]),
                           "partial": args[15], "B": args[17], "K": args[18], "D": args[19],
                           "T": args[20], "m": args[21], "plan": mlp_plan.MlpPlan(*args[22:25])})
        return 0


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    empty = torch.empty

    def spy_empty(*shape, **kw):
        t = empty(*shape, **kw)
        if t.ndim == 3:  # the window partials are the wrapper's only 3-D allocation
            rec.scratch.append((t.data_ptr(), tuple(t.shape), t.dtype))
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


@pytest.mark.parametrize("k,d,t", [(768, 768, 24), (1000, 1000, 24), (256, 700, 5)])
@pytest.mark.parametrize("value_dtype,kind", [("dense", 0), ("int8", 2), ("int4", 3)])
def test_plan_independent_of_batch(recorder, k, d, t, value_dtype, kind):
    """At B = 1, 4, 8 and 9 the wrapper passes one call with the plan of
    ``mlp_plan(K, D)`` and a (T, B, D) fp32 scratch for the window
    partials: the plan never sees B."""
    (gv, gp, gs), (uv, up, us) = (_operands(t, k, 48, value_dtype) for _ in range(2))
    dv, dp, ds = _operands(t, d, 32, value_dtype)
    plans = []
    for b in (1, 4, 8, 9):
        recorder.calls.clear()
        recorder.scratch.clear()
        out = packed_mod.vusa_fused_mlp_matmul(torch.empty((b, k)), gv, gp, uv, up, dv, dp, gs,
                                               us, ds, value_dtype=value_dtype)
        assert out.shape == (b, d)
        (call,) = recorder.calls
        assert (call["B"], call["K"], call["D"], call["T"], call["m"], call["kind"],
                call["S"]) == (b, k, d, t, 128, kind, (48, 48, 32))
        (scratch,) = recorder.scratch
        assert scratch == (call["partial"], (t, b, d), torch.float32)
        assert mlp_plan.cuda_launches(call["plan"], b, d, t) == 2
        plans.append(call["plan"])
    assert plans == [mlp_plan.mlp_plan(k, d)] * 4


@pytest.mark.parametrize(
    "n,rows", [(0, 32), (1, 32), (100, 32), (256, 32), (257, 64), (700, 96), (768, 96),
               (1000, 128), (3072, 384)])
def test_slices_follow_row_count(n, rows):
    """ceil(n / 8) rows per slice rounded up to whole 32-row chunks, at
    least one chunk; the eight slices cover the rows."""
    assert mlp_plan.slice_rows(n) == rows
    assert mlp_plan.CLUSTER * rows >= n
    assert mlp_plan.mlp_plan(n, 768) == mlp_plan.MlpPlan(cluster=8, rows=rows, down_rows=96)


@pytest.mark.parametrize("b,d,t,launches", [(4, 768, 24, 2), (0, 768, 24, 0), (4, 0, 24, 0),
                                            (4, 768, 0, 0), (9, 1000, 3, 2)])
def test_cuda_launches_of_a_call(b, d, t, launches):
    """Two CUDA launches a call (the cluster kernel and the ordered window
    sum); none for an empty output, and none without a window (the output
    is zeroed by a memset)."""
    assert mlp_plan.cuda_launches(mlp_plan.mlp_plan(768, d), b, d, t) == launches


def _packs(rng, d, ff, kind, m=128, a=16, sparsity=0.85):
    vd = kind if kind in ("int8", "int4") else "dense"
    out = []
    for shape, pack in (((d, ff), ops.pack_linear_rows), ((d, ff), ops.pack_linear_rows),
                        ((ff, d), ops.pack_linear_rows_t)):
        w = (rng.normal(size=shape) * (rng.random(shape) >= sparsity)).astype(np.float32)
        w[5] = 0.0  # an all-zero row
        p = pack(w, m=m, a=a, device="cpu", value_dtype=vd)
        if kind == "bfloat16":
            p = dataclasses.replace(p, values=p.values.to(torch.bfloat16))
        out.append(p)
    pg, pu, pd = out
    args = (pg.values, pg.positions, pu.values, pu.positions, pd.values, pd.positions,
            pg.scales, pu.scales, pd.scales)
    return args, vd


def _close(got, want, tol=TOL):
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * max(float(want.float().abs().max()), 1.0), err


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d,ff,a", [(768, 3072, 16), (1000, 600, 3), (200, 300, 16),
                                    (100, 130, 3)])
def test_sliced_order_matches_plain_and_is_batch_invariant(kind, d, ff, a):
    """The kernel's order of operations within 1e-5 of the plain version,
    for every value kind (a = 16 and odd a = 3; K and D off the slice size
    and ff % m != 0 among the shapes), and bitwise the same row whatever B
    holds."""
    rng = np.random.default_rng(21)
    args, vd = _packs(rng, d, ff, kind, a=a + (a % 2 if kind == "int4" else 0))
    x = torch.from_numpy(rng.normal(size=(9, d)).astype(np.float32))
    got = ref.vusa_fused_mlp_sliced_ref(x, *args, m=128, value_dtype=vd)
    assert got.shape == (9, d)
    _close(got, ref.vusa_fused_mlp_ref(x, *args, m=128, value_dtype=vd))
    for b in (1, 4):
        assert torch.equal(ref.vusa_fused_mlp_sliced_ref(x[:b], *args, m=128, value_dtype=vd),
                           got[:b])
    assert torch.equal(ref.vusa_fused_mlp_sliced_ref(x[4:], *args, m=128, value_dtype=vd),
                       got[4:])


def test_sliced_order_skips_idle_slots_and_lanes_past_the_window():
    """A NaN value in an idle slot or at a position past m stays out of
    the down gather, and an all-zero gate makes the output exactly zero."""
    rng = np.random.default_rng(22)
    args, vd = _packs(rng, 96, 200, "float32", m=100)
    gv, gp, uv, up, dv, dp, *_ = args
    dv, dp = dv.clone(), dp.clone()
    dp[:, :, -1] = -1
    dv[:, :, -1] = float("nan")
    dp[0, 3, 0], dv[0, 3, 0] = 120, float("nan")  # past the window of m = 100
    x = torch.from_numpy(rng.normal(size=(4, 96)).astype(np.float32))
    got = ref.vusa_fused_mlp_sliced_ref(x, gv, gp, uv, up, dv, dp, m=100, value_dtype=vd)
    assert bool(torch.isfinite(got).all())
    _close(got, ref.vusa_fused_mlp_ref(x, gv, gp, uv, up, dv, dp, m=100, value_dtype=vd))
    zero = ref.vusa_fused_mlp_sliced_ref(x, torch.zeros_like(gv), gp, uv, up, dv, dp, m=100,
                                         value_dtype=vd)
    assert torch.equal(zero, torch.zeros_like(zero))


def _jax(t, bf16=False):
    if t is None:
        return None
    if bf16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d,ff,m", [(100, 300, 128), (72, 200, 64)])
def test_sliced_order_matches_pallas(kind, d, ff, m):
    """The kernel's order of operations within 1e-5 of the Pallas
    ``vusa_fused_mlp_matmul`` in interpret mode (its ``_fused_mlp_kernel``
    and ``_fused_mlp_qkernel``), at m = 128 and m = 64."""
    rng = np.random.default_rng(23)
    args, vd = _packs(rng, d, ff, kind, m=m, a=4)
    x = rng.normal(size=(4, d)).astype(np.float32)
    bf16 = kind == "bfloat16"
    jargs = [_jax(a, bf16 and i in (0, 2, 4)) for i, a in enumerate(args)]
    want = np.array(pallas_fused(jnp.asarray(x), *jargs, m=m, k_blk=32, interpret=True,
                                 value_dtype=vd))
    got = ref.vusa_fused_mlp_sliced_ref(torch.from_numpy(x), *args, m=m, value_dtype=vd)
    assert got.shape == want.shape
    _close(got, torch.from_numpy(want))
