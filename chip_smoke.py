#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--spin-cycles N]

``--spin-cycles`` sets the kernel timer's device spin before each timed
call (default 10^6 cycles, about 0.5 ms); it is there to show that a
reading does not depend on it.

Phases, each of which fails the run (exit code 1, no result line) if it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the main path from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` and print ``ptxas``'s register / shared-memory
   report; then time an empty kernel of the B1-B4 library under the kernel
   timer below: the floor of one launch, printed on its own line;
3. hold each kernel against its plain PyTorch version at the shapes of the
   ``vusa_edge`` decode step (layer-0 packs of the real model below: wq/wk/wv/wo
   768 -> 768, the LM head 768 -> 32000, the fused MLP 768 / 3072) and at edge
   shapes (sparsity 0 and 0.99, all-zero rows, C % m != 0, odd slot counts,
   and for B1/B3 K = 1000, whose last slice is short, with a = 16 and with
   a = 3, whose chunk starts take narrower copies, and K = 3072, the
   ``fused_mlp=False`` w_down shape), for B in {1, 4, 5} (5 = the rows of
   the batched speculative verify, ``draft_k`` + 1) and fp32 / bf16
   activations, and for B2/B4 an odd slot count (a = 3), d = 1000 (K and D
   off the slice size) and ff % m != 0; every call's CUDA launches, counted
   by the library, must equal its plan's (B1/B3 ``row_plan``: one launch,
   or two when the plan splits K; B2/B4 ``mlp_plan``: the cluster kernel
   and the ordered window sum): B1/B2 with fp32 and bf16
   values, B3/B4 (the same kernels' int8 and int4 routes) with the int8 and
   int4 packs of the same model.  Tolerance: max |kernel - plain| <= 1e-4 *
   max |plain| for every dtype (bf16 inputs widen to fp32 exactly, int8/int4
   values dequantize to the same fp32 products q * scale, and both sides
   accumulate in fp32, so only the summation order differs).  Row 0 at
   B = 4 and at B = 5 must equal B = 1 bitwise.  Each kernel is timed with CUDA events
   (L2 flushed before each launch, as the decode step finds it) beside the
   plain version, one PyTorch library call on the dense (dequantized) fp32
   weights and the least time the card could take (bytes over 3.35 TB/s vs
   fp32 operations over 67 TFLOP/s, H100 SXM data sheet; the bytes are x,
   the output, every pack position, the value bytes of the occupied slots
   only (int4: half a byte) and the quantized packs' fp32 scales);
4. the main path: ``vusa_edge`` at full width (12 layers, d 768, ff 3072,
   vocab 32000), numpy-seeded init, 85 % magnitude pruning,
   ``Engine(packed_weights="all").generate`` with B = 4, prompt 32, 32 new
   tokens, in the eager loop (``fused=False``, as in phases 4-5; phase 7
   runs the CUDA graph).  The launch counters, set to 0 just before and read just after,
   must be exactly 49 * 31 (``vusa_packed_matmul``) and 12 * 31
   (``vusa_fused_mlp_matmul``), all on the float-value route, the CUDA
   launches the B1-B4 library counts for each entry point in that run equal
   to the plan's (``row_plan`` for each projection and the head,
   ``mlp_plan`` for each fused MLP), and the tokens
   finite and in range.  The same weights in fp32: the first decode step's
   packed and dense logits must agree to 1e-2 of the largest logit at full
   depth, and with the depth cut to 2 layers packed and dense greedy tokens
   must be identical.  At full depth free-running fp32 tokens can part at a
   near-tie; their agreement is reported beside a witness that runs no
   kernel of the port: the dense path against itself with every MLP's ff
   lanes permuted (the same function, summed in another order).  bf16's
   token agreement and first-step logit gap are reported too;
5. the quantized main path: the same ``generate`` with
   ``packed_values="int8"`` and ``"int4"``, each counted alone: B3 exactly
   49 * 31 and B4 exactly 12 * 31 launches on that route and none on any
   other, CUDA launches as planned, tokens finite and in range; tok/s, pack bytes per step and byte
   ratio.  In fp32, each quantized engine against the dense engine on
   ``qdq_lm_params`` (the same quantize-dequantize values), decoding from
   one primed cache (the quantized engine prefills dense on the unquantized
   weights): first-step logits within 1e-2 of the largest logit at full
   depth, identical greedy tokens on the 2-layer cut, full-depth token
   agreement reported beside phase 4's witness.  Decode tok/s of the three
   packs taken in turns (reported, not gated);
6. paper workloads, the paper's own A/B comparison at full size: every
   im2col GEMM of ResNet-18 (21, pruned to 85 %) and MobileNetV1 (28,
   75 %) at 224 x 224, B = output pixels, weights ``normal(K, C)`` from a
   numpy seed magnitude-pruned per layer by the quantile rule of
   ``benchmarks/run.py _prune_masks`` (copied here), activations
   ``normal(B, K)`` fp32 from the same generator.  Each model is one
   counted run: all counts set to 0, then per GEMM
   ``ops.apply_packed(x, ops.pack_linear(w, 32, 8, 128))`` (B5,
   ``vusa_spmm`` with ``ncols = C``) and ``ops.matmul`` on x and w
   zero-padded to the reference's tile contract (B6, ``dense_matmul``);
   exactly one counted launch of each per GEMM and none of B1-B4.  A call
   whose plan splits the reduction issues a second CUDA launch, the ordered
   sum of the slices: each library counts the CUDA launches the runtime
   accepts, read before and after each call of the counted run, and each
   GEMM's count must equal its plan's (``tile_plan.cuda_launches``);
   ``cuda_launches_per_call`` is their mean per GEMM.  Each
   output within 1e-4 of the largest |plain| of its plain version, and
   within 1e-3 (of the largest |x @ w|, at least 1) of ``x @ w`` in true
   fp32; bf16 x on three GEMMs per model
   (B5 then rounds its output to bf16, as its plain version does: one bf16
   step, 2**-7 of the value, allowed on top).  Per GEMM, CUDA events with L2
   flushed: kernel, plain version, ``torch.matmul(x, w)`` fp32 as the
   library call, and the bound (bytes over 3.35 TB/s against the kernels'
   TF32 tensor-core operations over 495 TFLOP/s, three per logical fp32
   product, the 3xTF32 split; B5: values, ``row_idx``, x and the (B, C)
   output with 2*B*J*A*C logical operations; B6: the padded operands and
   output with 2*M*N*K; the fp32 67 TFLOP/s bound of earlier runs kept
   beside it as ``bound_fp32_ms``), and each kernel's launch plan (slices
   S, tile BM x BN, stage KS, ``kernels/tile_plan.py``).  Per ResNet-18
   layer group (conv0, layer1-4, fc): B5, B6 and library ms and logical
   TFLOP/s (2*B*K*C over the time).  Per model: the sums, the B5/B6 ratio,
   the packs' compression and virtual growth, beside the cycle simulator's
   VUSA 3x6 (``schedule_widths_fast`` + ``ws_cycles``, as
   ``benchmarks/run.py`` reckons it) and standard 3x6 (``gemm_cycles_standard``) cycles for the
   same masks;
7. graph decode: phase 4's ``generate`` (B = 4, prompt 32, 32 new tokens)
   with ``fused=True``, each decode step a replay of one step captured in
   a CUDA graph, dense and packed with fp32, int8 and int4 values: the
   tokens must equal the eager loop's bitwise, greedy and sampled (the
   engine's seeded Gumbel noise); on the packed routes the graph's
   launches (replays x the wrapper launches captured in one step) must be
   exactly 49 * 31 and 12 * 31 on the route.  Reported: tok/s of graph and
   eager taken in turns, ms per step, and from a ``torch.profiler`` trace
   of 8 replays (device activity) the device's busy time per step (the
   union of its events' intervals) over the step's time between CUDA
   events, the host time outside it, the device events and the B1-B4
   kernels' time per step; the same for 8 eager steps on the fp32 pack.
   One packed step captured in debug mode: its DOT dump's B1-B4 kernel
   nodes must be the step's planned CUDA launches (49 row-packed, 12
   fused-MLP kernels, 61 ordered sums);
8. speculative: full-width ``vusa_edge`` on weights with the tier
   structure of ``tests/test_spec_decode.py`` (a 1 % core and a 14 %
   detail tier), B = 1, ``draft_k`` 4, drafter at 99 % sparsity, 32 new
   tokens, the verifier dense and packed with fp32 and with int8 values:
   speculative tokens (one round a graph replay) must equal plain graph
   decode's bitwise, greedy and sampled.  Reported: acceptance, rounds,
   tok/s in turns, and on the packed routes one drafter step's and one
   5-token verify's device time (B1-B4 kernels and all) from a trace of 3
   of each;
9. one JSON line of every ported kernel (B1-B4 per decode step at B = 4,
   launches in the counted run and per decode step, the graph run's
   launches, CUDA launches per call as counted; B5/B6 per ResNet-18
   image, MobileNetV1 under ``mobilenetv1``);
10. the card line again and the result line.

TF32 is switched off explicitly: every dense fp32 product here is true fp32.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.pruning import prune_tree  # noqa: E402
from repro_torch.core.simulator import gemm_cycles_standard, ws_cycles  # noqa: E402
from repro_torch.core.vusa import schedule_widths_fast  # noqa: E402
from repro_torch.core.workloads import mobilenetv1_gemms, resnet18_gemms  # noqa: E402
from repro_torch.kernels import build, mlp_plan, ops, ref, row_plan, tile_plan  # noqa: E402
from repro_torch.kernels.dense_matmul import (  # noqa: E402
    cuda_launches as dense_cuda_launches,
    dense_matmul,
    reset_launch_counts as reset_dense_counts,
)
from repro_torch.kernels.vusa_packed import (  # noqa: E402
    cuda_launches as packed_cuda_launches,
    empty_kernel,
    reset_launch_counts,
    vusa_fused_mlp_matmul,
    vusa_packed_matmul,
)
from repro_torch.kernels.vusa_spmm import (  # noqa: E402
    cuda_launches as spmm_cuda_launches,
    reset_launch_counts as reset_spmm_counts,
    vusa_spmm,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import strict_fp32  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402
from repro_torch.serve.packed import (  # noqa: E402
    _as_linear,
    _flat_entries,
    lm_decode_step_packed,
    packed_byte_ratios,
    qdq_lm_params,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores
TF32_PASSES = 3  # B5/B6 run three TF32 products per fp32 one (3xTF32)
TOL = 1e-4  # kernel vs plain, of the largest plain output
SPIN_CYCLES = 1_000_000  # the timer's device spin before each timed call (--spin-cycles)
BATCH, PROMPT, MAX_NEW = 4, 32, 32
DEPTH_CUT = 2  # layers of the fp32 token-identity check
FP32_STEP_TOL = 1e-2  # fp32 first-step logits, packed vs dense, of the largest logit
DEVICE = "cuda"
QDTYPES = ("int8", "int4")
DRAFT_K, DRAFT_SPARSITY = 4, 0.99  # the speculative phase's drafter
VERIFY_ROWS = DRAFT_K + 1  # rows of the batched verify: contract 1 is checked there too
PROFILED_STEPS = 8  # decode steps (graph replays) under the profiler per trace
LIBRARY_KERNELS = ("row_packed_kernel", "fused_mlp_kernel", "sum_slices_kernel")
# paper workloads: (name, GEMMs, pruning rate); the seed of weights and x
PAPER_MODELS = (("resnet18", resnet18_gemms, 0.85), ("mobilenetv1", mobilenetv1_gemms, 0.75))
PAPER_SEED = 0
EXACT_TOL = 1e-3  # kernels vs x @ w in fp32, of the largest |x @ w| (at least 1)
VUSA_NMA = (3, 6, 3)  # the paper's VUSA 3x6: N rows, M SPEs, A MACs
# ResNet-18's layer groups by GEMM name (the 1x1 downsample convs in their group)
RESNET18_GROUPS = (("conv0", ("conv0",)),
                   ("layer1", tuple(f"conv{i}" for i in range(1, 5))),
                   ("layer2", tuple(f"conv{i}" for i in range(5, 10))),
                   ("layer3", tuple(f"conv{i}" for i in range(10, 15))),
                   ("layer4", tuple(f"conv{i}" for i in range(15, 20))),
                   ("fc", ("fc",)))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        fail(f"nvidia-smi exited {r.returncode}: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------


class Timer:
    """Device time of one call, averaged over ``iters`` launches, each after
    an L2 flush (a 128 MiB write) and a device-side spin of SPIN_CYCLES
    (about 0.5 ms by default), so the call is enqueued before its start
    event fires (a wrapper's host work is not timed, even on a slow host)
    and finds a cold L2."""

    def __init__(self, iters: int = 20):
        self.iters = iters
        self.flush = torch.empty(32 * 2**20, dtype=torch.float32, device=DEVICE)

    def __call__(self, fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(self.iters):
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / self.iters


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max(max |want|, 1))."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1.0)


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def pack_bytes_needed(lin) -> float:
    """Bytes a kernel must read of one pack: every position (idle slots are
    marked there), a value only where the slot is occupied (an idle slot's
    value never reaches the output; int4 holds half a byte per slot), and
    every scale of a quantized pack."""
    nnz = int((lin.positions >= 0).sum())
    per_value = 0.5 if lin.value_dtype == "int4" else lin.values.element_size()
    scales = 0 if lin.scales is None else nbytes(lin.scales)
    return nbytes(lin.positions) + per_value * nnz + scales


def dequantized_dense(lin) -> torch.Tensor:
    """The (k, c) dense fp32 weight a pack holds (quantized values as
    q * scale)."""
    vals = ref.dequantize_values(lin.values, lin.scales, lin.value_dtype)
    return ref.unpack_dense(vals, lin.positions, lin.m)[:, : lin.c].contiguous()


def pack_bytes(packed) -> int:
    """Device bytes of every pack entry: values, positions and scales."""
    return sum(nbytes(*(e[k] for k in ("values", "positions", "scales") if k in e))
               for e in _flat_entries(packed).values())


def dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def check_cases(name, kern, plain, xs):
    """Kernel vs plain over the activations ``xs``, plus batch invariance."""
    cases = []
    for x in xs:
        got, want = kern(x), plain(x)
        err, rel = rel_err(got, want)
        if rel > TOL:
            fail(f"{name} x={x.dtype} B={x.shape[0]}: kernel vs plain error {err} ({rel} relative)")
        if x.shape[0] > 1 and not torch.equal(kern(x[:1].contiguous())[0], got[0]):
            fail(f"{name} x={x.dtype}: row 0 at B={x.shape[0]} differs from B=1")
        cases.append({"B": x.shape[0], "x": dtype_name(x), "max_abs_err": err, "rel_err": rel})
    return cases


def check_packed_matmul(timer, name, lin, xs, time_it):
    """B1 (float values) or B3 (int8/int4 values) at one operand set; returns
    a record (timed at ``xs[-1]``)."""
    rec = {"name": name, "shape": [lin.k, lin.c], "T": lin.values.shape[0], "S": lin.slots,
           "values": dtype_name(lin.values), "value_dtype": lin.value_dtype}
    args = (lin.values, lin.positions, lin.scales)
    kw = {"m": lin.m, "value_dtype": lin.value_dtype}

    def kern(x):
        return vusa_packed_matmul(x, *args, **kw)

    def plain(x):
        return ref.vusa_packed_ref(x, *args, **kw)

    def counted(x):  # the CUDA launches of one call, held against its plan
        c0 = packed_cuda_launches("vusa_packed_matmul")
        y = kern(x)
        got = packed_cuda_launches("vusa_packed_matmul") - c0
        want = row_plan.cuda_launches(row_plan.row_plan(lin.k), x.shape[0], y.shape[1])
        if got != want:
            fail(f"{name} B={x.shape[0]}: {got} CUDA launches, its plan takes {want}")
        return y

    rec["plan"] = row_plan.row_plan(lin.k)._asdict()
    rec["cases"] = check_cases(name, counted, plain, xs)
    if time_it:
        x = xs[-1]
        dense = dequantized_dense(lin)
        if lin.value_dtype == "dense":
            dense = dense.to(lin.values.dtype)
        xd = x.to(dense.dtype)
        nnz = int((lin.positions >= 0).sum())
        dequant_ops = 0 if lin.value_dtype == "dense" else nnz
        out_bytes = x.shape[0] * lin.values.shape[0] * lin.m * 4
        b_ms, b_by = bound_ms(nbytes(x) + pack_bytes_needed(lin) + out_bytes,
                              2 * x.shape[0] * nnz + dequant_ops)
        rec["timing"] = {
            "B": x.shape[0], "x": dtype_name(x), "ms": timer(lambda: kern(x)),
            "plain_ms": timer(lambda: plain(x)),
            "library_ms": timer(lambda: torch.matmul(xd, dense)),
            "library_call": f"torch.matmul(x, W) on the dense {dtype_name(dense)} weight",
            "bound_ms": b_ms, "bound_by": b_by, "nnz": nnz,
        }
    return rec


def check_fused_mlp(timer, name, gate, up, down_t, xs, time_it):
    """B2 (float values) or B4 (int8/int4 values) at one operand set; returns
    a record (timed at ``xs[-1]``)."""
    lins = (gate, up, down_t)
    args = (gate.values, gate.positions, up.values, up.positions, down_t.values,
            down_t.positions, gate.scales, up.scales, down_t.scales)
    kw = {"m": gate.m, "value_dtype": gate.value_dtype}
    rec = {"name": name, "d": gate.k, "ff": gate.c, "T": gate.values.shape[0],
           "S": [lin.slots for lin in lins], "values": dtype_name(gate.values),
           "value_dtype": gate.value_dtype}

    def kern(x):
        return vusa_fused_mlp_matmul(x, *args, **kw)

    def plain(x):
        return ref.vusa_fused_mlp_ref(x, *args, **kw)

    plan = mlp_plan.mlp_plan(gate.k, down_t.k)

    def counted(x):  # the CUDA launches of one call, held against its plan
        c0 = packed_cuda_launches("vusa_fused_mlp_matmul")
        y = kern(x)
        got = packed_cuda_launches("vusa_fused_mlp_matmul") - c0
        want = mlp_plan.cuda_launches(plan, x.shape[0], down_t.k, gate.values.shape[0])
        if got != want:
            fail(f"{name} B={x.shape[0]}: {got} CUDA launches, its plan takes {want}")
        return y

    rec["plan"] = plan._asdict()
    rec["cases"] = check_cases(name, counted, plain, xs)
    if time_it:
        x = xs[-1]
        wg, wu, wd = (dequantized_dense(lin) for lin in lins)
        wd = wd.T.contiguous()
        if gate.value_dtype == "dense":
            wg, wu, wd = (w.to(gate.values.dtype) for w in (wg, wu, wd))
        xd = x.to(wg.dtype)
        silu = torch.nn.functional.silu
        nnz = sum(int((lin.positions >= 0).sum()) for lin in lins)
        dequant_ops = 0 if gate.value_dtype == "dense" else nnz
        packs = sum(pack_bytes_needed(lin) for lin in lins)
        b_ms, b_by = bound_ms(nbytes(x) + packs + x.shape[0] * down_t.k * 4,
                              2 * x.shape[0] * nnz + dequant_ops)
        rec["timing"] = {
            "B": x.shape[0], "x": dtype_name(x), "ms": timer(lambda: kern(x)),
            "plain_ms": timer(lambda: plain(x)),
            "library_ms": timer(lambda: torch.matmul(silu(xd @ wg) * (xd @ wu), wd)),
            "library_call": "dense SwiGLU: three torch.matmul calls + silu",
            "bound_ms": b_ms, "bound_by": b_by, "nnz": nnz,
        }
    return rec


def kernel_phase(cfg, packs, rng):
    """Phase 3 over ``packs`` (``{"dense": bf16-path pack, "int8": ...,
    "int4": ...}`` of the model).  Returns (records, per-decode-step totals
    per route: ``{route: {kernel: {...}}}``)."""
    timer = Timer()
    dev = torch.device(DEVICE)

    def xs_for(k):
        x1, x4 = (torch.from_numpy(rng.standard_normal((b, k), dtype=np.float32)).to(dev)
                  for b in (1, BATCH))
        x5 = torch.cat([x4, x1])  # VERIFY_ROWS: the batched speculative verify's rows
        # the last one is the main path's: B = 4, bf16 activations
        return [v for x in (x1, x5, x4) for v in (x, x.to(torch.bfloat16))]

    def bf16_copy(lin):
        return dataclasses.replace(lin, values=lin.values.to(torch.bfloat16))

    def sparse(k, c, s):
        w = rng.standard_normal((k, c), dtype=np.float32)
        return w * (rng.random((k, c)) >= s)

    d, L = cfg.d_model, cfg.n_layers
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    records, step = [], {}
    for route, packed in packs.items():
        tag = "" if route == "dense" else f" {route}"
        mlp = packed["mlp"]
        # main-path shapes, timed: the model's own layer-0 packs and its head
        attn_recs = [check_packed_matmul(timer, f"{n}[layer0]{tag}",
                                         _as_linear(packed["attn"][n], 0), xs_for(d), True)
                     for n in ("wq", "wk", "wv", "wo")]
        head_rec = check_packed_matmul(timer, f"lm_head{tag}", _as_linear(packed["head"]),
                                       xs_for(d), True)
        trio = [_as_linear(mlp[n], 0) for n in ("w_gate", "w_up", "w_down_t")]
        mlp_rec = check_fused_mlp(timer, f"mlp[layer0]{tag}", *trio, xs_for(d), True)
        records += attn_recs + [head_rec, mlp_rec]
        if route == "dense":  # bf16 values at the main-path shapes
            records.append(check_packed_matmul(timer, "wq[layer0] bf16 values",
                                               bf16_copy(_as_linear(packed["attn"]["wq"], 0)),
                                               xs_for(d), False))
            records.append(check_fused_mlp(timer, "mlp[layer0] bf16 values",
                                           *[bf16_copy(lin) for lin in trio], xs_for(d), False))
        # one decode step's worth: each layer's 4 projections + the head; L MLPs
        b_name = "vusa_packed_matmul" if route == "dense" else "vusa_packed_matmul_quantized"
        f_name = "vusa_fused_mlp_matmul" if route == "dense" else "vusa_fused_mlp_matmul_quantized"
        step[route] = {
            b_name: {k: L * sum(r["timing"][k] for r in attn_recs) + head_rec["timing"][k]
                     for k in keys},
            f_name: {k: L * mlp_rec["timing"][k] for k in keys},
        }
        step[route][b_name]["max_abs_err"] = max(
            c["max_abs_err"] for r in attn_recs + [head_rec] for c in r["cases"])
        step[route][f_name]["max_abs_err"] = max(c["max_abs_err"] for c in mlp_rec["cases"])
        step[route][b_name]["bound_by"] = head_rec["timing"]["bound_by"]
        step[route][f_name]["bound_by"] = mlp_rec["timing"]["bound_by"]

    # edge shapes, every route
    zero_rows = sparse(768, 768, 0.85)
    zero_rows[100:300] = 0.0
    zero_rows[:, 200:260] = 0.0
    edges = (("sparsity 0", sparse(768, 768, 0.0), 16),
             ("sparsity 0.99", sparse(768, 768, 0.99), 16),
             ("C % m != 0", sparse(768, 700, 0.85), 16), ("all-zero rows", zero_rows, 16),
             ("odd slot count (a = 3)", sparse(768, 768, 0.85), 3),
             ("K = 1000, a slice off the slice size", sparse(1000, 768, 0.85), 16),
             ("K = 1000, a = 3: unaligned chunk starts", sparse(1000, 768, 0.85), 3),
             ("K = 3072, the w_down shape", sparse(3072, 768, 0.85), 16))
    mlp_edges = []
    for label, s, dm, ff, a in (
            ("mlp sparsity 0", 0.0, 768, 3072, 16), ("mlp sparsity 0.99", 0.99, 768, 3072, 16),
            ("mlp all-zero rows, ff % m != 0", 0.85, 768, 3000, 16),
            ("mlp odd slot count (a = 3)", 0.85, 768, 3072, 3),
            ("mlp d = 1000, slices off the slice size, a = 3", 0.85, 1000, 3072, 3)):
        wg, wu, wd = sparse(dm, ff, s), sparse(dm, ff, s), sparse(ff, dm, s)
        if ff % 128:
            wg[10:300] = 0.0
            wu[:, 40:400] = 0.0
            wd[5:600] = 0.0
        mlp_edges.append((label, wg, wu, wd, a))
    for route in packs:
        vd = {"value_dtype": route, "device": dev}
        tag = "" if route == "dense" else f" {route}"
        for label, w, a in edges:
            records.append(check_packed_matmul(
                timer, label + tag, ops.pack_linear_rows(w, a=a, **vd), xs_for(w.shape[0]),
                False))
        for label, wg, wu, wd, a in mlp_edges:
            records.append(check_fused_mlp(
                timer, label + tag, ops.pack_linear_rows(wg, a=a, **vd),
                ops.pack_linear_rows(wu, a=a, **vd), ops.pack_linear_rows_t(wd, a=a, **vd),
                xs_for(wg.shape[0]), False))
    return records, step


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------


def prompts_for(cfg):
    return np.random.default_rng(1).integers(1, cfg.vocab, size=(BATCH, PROMPT)).astype(np.int32)


def planned_cuda_launches(cfg, packed) -> dict:
    """CUDA launches one decode step at B = ``BATCH`` must issue, by entry
    point: each projection and the head by its ``row_plan`` (K alone), and
    each fused MLP by its ``mlp_plan`` (K and D)."""
    def calls(lin):
        return row_plan.cuda_launches(row_plan.row_plan(lin.k), BATCH,
                                      lin.values.shape[0] * lin.m)

    attn = sum(calls(_as_linear(packed["attn"][n], 0)) for n in ("wq", "wk", "wv", "wo"))
    gate, down_t = (_as_linear(packed["mlp"][n], 0) for n in ("w_gate", "w_down_t"))
    mlp = mlp_plan.cuda_launches(mlp_plan.mlp_plan(gate.k, down_t.k), BATCH, down_t.k,
                                 gate.values.shape[0])
    return {"vusa_packed_matmul": cfg.n_layers * attn + calls(_as_linear(packed["head"])),
            "vusa_fused_mlp_matmul": cfg.n_layers * mlp}


def counted_run(cfg, eng, route):
    """Warm up, set every launch count to 0, run the main path once and read
    the counts: exactly 49 * 31 ``vusa_packed_matmul`` and 12 * 31
    ``vusa_fused_mlp_matmul`` launches, all on ``route``, and the CUDA
    launches that the kernel library counts for each entry point equal to
    the plan's (``planned_cuda_launches``).  Returns (generate's result,
    counts on ``route``, CUDA launches per call, peak device bytes)."""
    prompts = prompts_for(cfg)
    eng.generate(prompts, max_new=4)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    entries = ("vusa_packed_matmul", "vusa_fused_mlp_matmul")
    cuda0 = {name: packed_cuda_launches(name) for name in entries}
    reset_launch_counts()
    out = eng.generate(prompts, max_new=MAX_NEW)  # <- the counted main-path run
    counts = {"vusa_packed_matmul": dict(vusa_packed_matmul.launches),
              "vusa_fused_mlp_matmul": dict(vusa_fused_mlp_matmul.launches)}
    cuda = {name: packed_cuda_launches(name) - cuda0[name] for name in entries}
    peak = torch.cuda.max_memory_allocated()
    steps = MAX_NEW - 1
    want = {name: {r: n * steps if r == route else 0 for r in counts[name]}
            for name, n in (("vusa_packed_matmul", 4 * cfg.n_layers + 1),
                            ("vusa_fused_mlp_matmul", cfg.n_layers))}
    if counts != want:
        fail(f"{route} main path: launch counts {counts} != expected {want}")
    want_cuda = {name: n * steps for name, n in planned_cuda_launches(cfg, eng.packed).items()}
    if cuda != want_cuda:
        fail(f"{route} main path: CUDA launches {cuda} != the plan's {want_cuda}")
    toks = out["tokens"]
    if toks.shape != (BATCH, MAX_NEW) or not out["finite"]:
        fail(f"{route} main path: tokens {toks.shape}, finite={out['finite']}")
    if toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"{route} main path: token ids outside the vocabulary")
    per_call = {name: cuda[name] / counts[name][route] for name in entries}
    return out, {name: c[route] for name, c in counts.items()}, per_call, peak


def first_layers(tree):
    """A stacked layer tree cut to its first ``DEPTH_CUT`` layers."""
    return {k: first_layers(v) if isinstance(v, dict) else v[:DEPTH_CUT] for k, v in tree.items()}


def model_phase(cfg, params, eng):
    prompts = prompts_for(cfg)
    out, counts, per_call, peak = counted_run(cfg, eng, "dense")
    res = {"launches": counts, "cuda_launches_per_call": per_call,
           "main": {"tok_per_s": out["tok_per_s"], "decode_s": out["decode_s"],
                    "prefill_s": out["prefill_s"], "peak_bytes": peak}}

    def run(c, p, packed_weights):
        e = Engine(c, p, ServeConfig(max_len=eng.sc.max_len, packed_weights=packed_weights,
                                     fused=False),
                   device=DEVICE)
        e.generate(prompts, max_new=4)
        return e, e.generate(prompts, max_new=MAX_NEW)

    def first_step_logits(c, e, step_params=None):
        """The first decode step's logits after ``e``'s (dense) prefill:
        through ``e``'s pack if it has one, else dense with ``step_params``
        (default ``e``'s own)."""
        with torch.no_grad():
            nxt, cache = e.prime(prompts)
            if e.packed is not None:
                return lm_decode_step_packed(e.params, e.packed, nxt, cache, c)[0]
            return e.model.decode_step(e.params if step_params is None else step_params,
                                       nxt, cache)[0]

    def agreement(a, b) -> float:
        return float((a["tokens"] == b["tokens"]).mean())

    def permute_ff(p):
        """The same function with every layer's MLP ff lanes permuted: the
        dense path then sums the down projection over ff in another order.
        No kernel of the port runs it; it is the witness of how far fp32
        rounding alone moves this model."""
        perm = torch.from_numpy(np.random.default_rng(2).permutation(cfg.d_ff)).to(DEVICE)
        ffn = p["layers"]["ffn"]
        ffn = {"w_gate": ffn["w_gate"][..., perm], "w_up": ffn["w_up"][..., perm],
               "w_down": ffn["w_down"][:, perm]}
        return {**p, "layers": {**p["layers"], "ffn": ffn}}

    def fp32_study(c, p):
        """Packed vs dense, and the witness (dense vs dense with the ff lanes
        permuted), in fp32: free-running greedy token agreement over
        ``MAX_NEW`` tokens, and the first decode step's logit gap (both
        sides from the same prefill cache and token)."""
        pe, pr = run(c, p, "all")
        de, dr = run(c, p, False)
        we, wr = run(c, permute_ff(p), False)
        if not (pr["finite"] and dr["finite"] and wr["finite"]):
            fail(f"fp32 {c.n_layers}-layer run produced non-finite logits")
        ld = first_step_logits(c, de)
        gap, rel = rel_err(first_step_logits(c, pe), ld)
        wgap, wrel = rel_err(first_step_logits(c, de, we.params), ld)
        return {"layers": c.n_layers, "packed_tok_per_s": pr["tok_per_s"],
                "dense_tok_per_s": dr["tok_per_s"],
                "token_agreement": agreement(pr, dr), "first_step_logit_gap": gap,
                "first_step_logit_gap_rel": rel,
                "witness_token_agreement": agreement(wr, dr),
                "witness_first_step_logit_gap": wgap, "witness_first_step_logit_gap_rel": wrel}

    dense_eng, dense = run(cfg, params, False)
    gap, rel = rel_err(first_step_logits(cfg, eng), first_step_logits(cfg, dense_eng))
    res["bf16"] = {"dense_tok_per_s": dense["tok_per_s"], "token_agreement": agreement(out, dense),
                   "first_step_logit_gap": gap, "first_step_logit_gap_rel": rel}

    # fp32 at full depth: the first step's packed and dense logits must agree
    # closely; free-running tokens are reported beside the witness's, since
    # a near-tie can part them (PERF.md, Open questions)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    res["fp32"] = fp32_study(cfg32, params)
    if res["fp32"]["first_step_logit_gap_rel"] > FP32_STEP_TOL:
        fail(f"fp32 first-step logits: packed vs dense gap {res['fp32']['first_step_logit_gap']} "
             f"({res['fp32']['first_step_logit_gap_rel']} of the largest logit)")

    # fp32 with the depth cut to DEPTH_CUT layers (same width and weights):
    # packed and dense greedy tokens must be identical
    cut = dataclasses.replace(cfg32, n_layers=DEPTH_CUT)
    res["fp32_depth_cut"] = fp32_study(cut, {**params, "layers": first_layers(params["layers"])})
    if res["fp32_depth_cut"]["token_agreement"] != 1.0:
        fail(f"fp32 {DEPTH_CUT}-layer packed and dense greedy tokens differ: "
             f"{res['fp32_depth_cut']['token_agreement']} agree")
    return res


def copy_cache(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in cache.items()}


def quantized_parity(c, p, route, max_len):
    """fp32: the ``route`` packed engine against the dense engine on
    ``qdq_lm_params``, both decoding from the quantized engine's primed
    cache (it prefills dense on the unquantized weights; the oracle would
    prefill on the qdq weights).  First-step logit gap and greedy token
    agreement over ``MAX_NEW`` steps."""
    qe = Engine(c, p, ServeConfig(max_len=max_len, packed_weights="all", packed_values=route,
                                  fused=False),
                device=DEVICE)
    oe = Engine(c, qdq_lm_params(c, p, value_dtype=route),
                ServeConfig(max_len=max_len, fused=False),
                device=DEVICE)
    with torch.no_grad():
        tok, cache = qe.prime(prompts_for(c))
        lq = lm_decode_step_packed(qe.params, qe.packed, tok, copy_cache(cache), c)[0]
        lo = oe.model.decode_step(oe.params, tok, copy_cache(cache))[0]
        tq, okq, _, _ = qe.decode_segment(tok, copy_cache(cache), MAX_NEW)
        to, oko, _, _ = oe.decode_segment(tok, copy_cache(cache), MAX_NEW)
    if not (bool(okq.all()) and bool(oko.all())):
        fail(f"fp32 {c.n_layers}-layer {route} parity run produced non-finite logits")
    gap, rel = rel_err(lq, lo)
    return {"layers": c.n_layers, "first_step_logit_gap": gap, "first_step_logit_gap_rel": rel,
            "token_agreement": float((tq == to).float().mean())}


def quantized_phase(cfg, params, qengs):
    """Phase 5: each quantized route's counted main-path run, and its fp32
    decode parity against ``qdq_lm_params`` at full depth and on the
    2-layer cut."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cut = dataclasses.replace(cfg32, n_layers=DEPTH_CUT)
    cut_params = {**params, "layers": first_layers(params["layers"])}
    res = {}
    for route, e in qengs.items():
        out, counts, per_call, peak = counted_run(cfg, e, route)
        r = {"launches": counts, "cuda_launches_per_call": per_call,
             "tok_per_s": out["tok_per_s"], "decode_s": out["decode_s"],
             "prefill_s": out["prefill_s"], "peak_bytes": peak,
             "pack_bytes_per_step": pack_bytes(e.packed),
             "byte_ratio": packed_byte_ratios(e.packed)["total"]}
        r["fp32"] = quantized_parity(cfg32, params, route, e.sc.max_len)
        if r["fp32"]["first_step_logit_gap_rel"] > FP32_STEP_TOL:
            fail(f"fp32 {route} first-step logits: packed vs qdq dense gap "
                 f"{r['fp32']['first_step_logit_gap']} ({r['fp32']['first_step_logit_gap_rel']} "
                 "of the largest logit)")
        r["fp32_depth_cut"] = quantized_parity(cut, cut_params, route, e.sc.max_len)
        if r["fp32_depth_cut"]["token_agreement"] != 1.0:
            fail(f"fp32 {DEPTH_CUT}-layer {route} packed and qdq dense greedy tokens differ: "
                 f"{r['fp32_depth_cut']['token_agreement']} agree")
        res[route] = r
    return res


def interleaved_tok_per_s(cfg, engines, rounds: int = 2):
    """Decode tok/s of each pack's ``generate``, taken in turns (routes in
    order, then reversed, per round) so that host drift during the call
    falls on every route alike.  Reported, not gated."""
    prompts = prompts_for(cfg)
    order = [*engines, *reversed(engines)]
    out = {route: [] for route in engines}
    for _ in range(rounds):
        for route in order:
            out[route].append(engines[route].generate(prompts, max_new=MAX_NEW)["tok_per_s"])
    return out


# --------------------------------------------------------------------------
# phase 6: paper workloads, block-VUSA (B5) against the dense baseline (B6)
# --------------------------------------------------------------------------


def prune_weights(gemms, rate, rng):
    """Per GEMM a ``normal(K, C)`` weight magnitude-pruned to ``rate`` by the
    quantile rule of ``benchmarks/run.py _prune_masks`` (same draws, same
    masks), as fp32."""
    out = []
    for g in gemms:
        w = rng.normal(size=(g.K, g.C))
        thresh = np.quantile(np.abs(w), rate)
        out.append((w * (np.abs(w) > thresh)).astype(np.float32))
    return out


def tile_pad(d: int) -> int:
    """``d`` zero-padded to the reference's ``dense_matmul`` contract: a
    dimension above 128 must be a multiple of 128."""
    return d if d <= 128 or d % 128 == 0 else -(-d // 128) * 128


def reset_all_launch_counts() -> None:
    reset_launch_counts()
    reset_spmm_counts()
    reset_dense_counts()


def all_launch_counts() -> dict:
    return {"vusa_spmm": vusa_spmm.launches, "dense_matmul": dense_matmul.launches,
            "vusa_packed_matmul": sum(vusa_packed_matmul.launches.values()),
            "vusa_fused_mlp_matmul": sum(vusa_fused_mlp_matmul.launches.values())}


def check_rounded(name, got, want):
    """Kernel vs plain: within TOL of the largest |plain| plus one rounding
    step of the output dtype (bf16: 2**-7 of the value; fp32: none)."""
    step = 2.0**-7 if got.dtype == torch.bfloat16 else 0.0
    err = (got.float() - want.float()).abs()
    scale = max(float(want.float().abs().max()), 1.0)
    if not bool((err <= TOL * scale + step * want.float().abs()).all()):
        fail(f"{name}: kernel vs plain error {float(err.max())} ({float(err.max()) / scale} "
             "relative)")
    return float(err.max())


def simulator_cycles(gemms, masks) -> dict:
    """VUSA 3x6 cycles (``schedule_widths_fast`` + ``ws_cycles`` per achieved
    window width, as ``benchmarks/run.py _evaluate_model``) and standard 3x6
    cycles (``gemm_cycles_standard``) for the same masks."""
    n, m, a = VUSA_NMA
    vusa = 0
    for g, mask in zip(gemms, masks):
        hist, _ = schedule_widths_fast(mask, n, m, a)
        vusa += sum(int(hist[w]) * ws_cycles(g.B, n, w) for w in range(a, m + 1))
    std = sum(gemm_cycles_standard(g, n, m) for g in gemms)
    return {"vusa_3x6": vusa, "standard_3x6": std, "ratio": vusa / std}


def paper_model(timer, name, gemms, rate):
    """One model of phase 6: the counted run, the checks, the timings."""
    rng = np.random.default_rng(PAPER_SEED)
    ws = prune_weights(gemms, rate, rng)
    xs = [torch.from_numpy(rng.standard_normal((g.B, g.K), dtype=np.float32)).to(DEVICE)
          for g in gemms]
    packs = [ops.pack_linear(w, 32, 8, 128, device=DEVICE) for w in ws]
    dense = [torch.from_numpy(w).to(DEVICE) for w in ws]
    padded = []  # B6 operands at the reference's tile contract (exact: zeros)
    for g, x, w in zip(gemms, xs, dense):
        kp, np_ = tile_pad(g.K), tile_pad(g.C)
        padded.append((F.pad(x, (0, kp - g.K)).contiguous(),
                       F.pad(w, (0, np_ - g.C, 0, kp - g.K)).contiguous()))
    torch.cuda.synchronize()

    reset_all_launch_counts()
    outs, cuda = [], []  # <- the counted run; CUDA launches per call from the libraries
    for x, p, (xp, wp) in zip(xs, packs, padded):
        c0 = spmm_cuda_launches()
        y5 = ops.apply_packed(x, p)
        c1 = dense_cuda_launches()
        y6 = ops.matmul(xp, wp)
        outs.append((y5, y6))
        cuda.append((spmm_cuda_launches() - c0, dense_cuda_launches() - c1))
    torch.cuda.synchronize()
    counts = all_launch_counts()
    want = {"vusa_spmm": len(gemms), "dense_matmul": len(gemms), "vusa_packed_matmul": 0,
            "vusa_fused_mlp_matmul": 0}
    if counts != want:
        fail(f"paper workloads {name}: launch counts {counts} != expected {want}")

    bf16_at = {0, len(gemms) // 2, len(gemms) - 1}
    rows = []
    for i, (g, x, p, w, (xp, wp), (y5, y6), (c5, c6)) in enumerate(
            zip(gemms, xs, packs, dense, padded, outs, cuda)):
        tag = f"paper workloads {name} {g.name}"
        exact = torch.matmul(x, w)
        err5 = check_rounded(f"{tag} vusa_spmm", y5, ops.apply_packed_ref(x, p))
        err6 = check_rounded(f"{tag} dense_matmul", y6, ref.dense_matmul_ref(xp, wp))
        for kname, y in (("vusa_spmm", y5), ("dense_matmul", y6[:, : g.C])):
            e, r = rel_err(y, exact)
            if r > EXACT_TOL:
                fail(f"{tag} {kname} vs x @ w: error {e} ({r} relative)")
        bf16 = {}
        if i in bf16_at:
            xb, xpb, wpb = x.to(torch.bfloat16), xp.to(torch.bfloat16), wp.to(torch.bfloat16)
            bf16 = {"vusa_spmm": check_rounded(f"{tag} vusa_spmm bf16 x", ops.apply_packed(xb, p),
                                               ops.apply_packed_ref(xb, p)),
                    "dense_matmul": check_rounded(f"{tag} dense_matmul bf16",
                                                  ops.matmul(xpb, wpb),
                                                  ref.dense_matmul_ref(xpb, wpb))}
        xk = F.pad(x, (0, p.k_padded - p.k)).contiguous()
        t, j, a, tn = p.values.shape
        flops5 = 2 * g.B * j * a * g.C
        flops6 = 2 * xp.shape[0] * wp.shape[1] * xp.shape[1]
        bytes5 = nbytes(p.values, p.row_idx, xk) + g.B * g.C * 4
        bytes6 = nbytes(xp, wp) + xp.shape[0] * wp.shape[1] * 4
        b5 = bound_ms(bytes5, TF32_PASSES * flops5, TF32_FLOPS)
        b6 = bound_ms(bytes6, TF32_PASSES * flops6, TF32_FLOPS)
        plan5, plan6 = tile_plan.plan(j * a), tile_plan.plan(xp.shape[1])
        for kname, got, want in (
                ("vusa_spmm", c5, tile_plan.cuda_launches(plan5, g.B, g.C)),
                ("dense_matmul", c6, tile_plan.cuda_launches(plan6, xp.shape[0], wp.shape[1]))):
            if got != want:
                fail(f"{tag} {kname}: {got} CUDA launches in the counted run, its plan takes "
                     f"{want}")
        rows.append({
            "gemm": g.name, "B": g.B, "K": g.K, "C": g.C, "k_padded": p.k_padded,
            "T": t, "J": j, "A": a, "compression": p.compression,
            "virtual_growth": p.virtual_growth, "logical_flops": 2 * g.B * g.K * g.C,
            "library_ms": timer(lambda: torch.matmul(x, w)),
            "vusa_spmm": {"ms": timer(lambda: vusa_spmm(xk, p.values, p.row_idx, g.C)),
                          "plain_ms": timer(lambda: ref.vusa_spmm_ref(xk, p.values, p.row_idx,
                                                                      g.C)),
                          "bound_ms": b5[0], "bound_by": b5[1],
                          "bound_fp32_ms": bound_ms(bytes5, flops5)[0], "max_abs_err": err5,
                          "max_abs_err_bf16": bf16.get("vusa_spmm"),
                          "flops": flops5, "plan": plan5._asdict(), "cuda_launches": c5},
            "dense_matmul": {"ms": timer(lambda: ops.matmul(xp, wp)),
                             "plain_ms": timer(lambda: ref.dense_matmul_ref(xp, wp)),
                             "bound_ms": b6[0], "bound_by": b6[1],
                             "bound_fp32_ms": bound_ms(bytes6, flops6)[0], "max_abs_err": err6,
                             "max_abs_err_bf16": bf16.get("dense_matmul"), "flops": flops6,
                             "padded": [xp.shape[0], xp.shape[1], wp.shape[1]],
                             "plan": plan6._asdict(), "cuda_launches": c6},
        })

    def total(kname):
        ks = [r[kname] for r in rows]
        out = {k: sum(r[k] for r in ks)
               for k in ("ms", "plain_ms", "bound_ms", "bound_fp32_ms", "flops")}
        by_ops = sum(r["bound_ms"] for r in ks if r["bound_by"] == "operations")
        out["bound_by"] = "operations" if 2 * by_ops >= out["bound_ms"] else "bytes"
        out["max_abs_err"] = max(r["max_abs_err"] for r in ks)  # fp32 x
        out["max_abs_err_bf16"] = max(r["max_abs_err_bf16"] for r in ks
                                      if r["max_abs_err_bf16"] is not None)
        out["library_ms"] = sum(r["library_ms"] for r in rows)
        out["launches"] = counts[kname]
        out["cuda_launches_per_call"] = sum(r["cuda_launches"] for r in ks) / len(ks)
        return out

    groups = {}
    for gname, members in (RESNET18_GROUPS if name == "resnet18" else ()):
        rs = [r for r in rows if r["gemm"] in members]
        flops = sum(r["logical_flops"] for r in rs)
        groups[gname] = {"gemms": len(rs), "logical_flops": flops}
        for key, ms in (("vusa_spmm", sum(r["vusa_spmm"]["ms"] for r in rs)),
                        ("dense_matmul", sum(r["dense_matmul"]["ms"] for r in rs)),
                        ("library", sum(r["library_ms"] for r in rs))):
            groups[gname][key] = {"ms": ms, "logical_tflop_per_s": flops / ms / 1e9}

    packed_bytes = sum(nbytes(p.values, p.row_idx) for p in packs)
    return {
        "gemms": len(gemms), "rate": rate, "launches": counts,
        "vusa_spmm": total("vusa_spmm"), "dense_matmul": total("dense_matmul"),
        "logical_flops": sum(r["logical_flops"] for r in rows),
        "compression_sum": sum(p.compression for p in packs),
        "byte_ratio": packed_bytes / sum(nbytes(w) for w in dense),
        "virtual_growth_mean": float(np.mean([p.virtual_growth for p in packs])),
        "simulator": simulator_cycles(gemms, [w != 0 for w in ws]),
        "layer_groups": groups, "per_gemm": rows,
    }


def paper_phase():
    """Phase 6 over ``PAPER_MODELS``; returns ``{model: summary}``."""
    timer = Timer()
    return {name: paper_model(timer, name, fn(), rate) for name, fn, rate in PAPER_MODELS}


# --------------------------------------------------------------------------
# phase 7: the decode loop as a CUDA graph; phase 8: speculative decoding
# --------------------------------------------------------------------------


def profile_window(fn) -> dict:
    """``fn()`` under ``torch.profiler`` (device activity only), ended by a
    synchronize: wall ms on the host clock, the device's busy ms (the union
    of the intervals of the trace's device events), their summed ms, and
    the summed ms of the B1-B4 library's kernels; and, outside the
    profiler, ``fn()``'s ms between two CUDA events (``unprofiled_ms``:
    tracing slows the host).  Busy is None when the trace holds no device
    event (then the device time is not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    unprofiled_ms = start.elapsed_time(end)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"wall_ms": wall_ms, "unprofiled_ms": unprofiled_ms,
            "busy_ms": busy / 1e3 if spans else None,
            "device_sum_ms": sum(b - a for a, b in spans) / 1e3, "device_events": len(spans),
            "library_kernel_ms": sum(e.time_range.elapsed_us() for e in dev
                                     if any(k in e.name for k in LIBRARY_KERNELS)) / 1e3}


def per_step(prof: dict, steps: int) -> dict:
    """A trace's numbers per step, the busy share (busy over wall) and the
    host time outside the device's busy time."""
    busy = prof["busy_ms"]
    out = {k: v / steps for k, v in prof.items() if k.endswith("_ms") and v is not None}
    out["busy_share"] = None if busy is None else busy / prof["wall_ms"]
    out["busy_share_unprofiled"] = None if busy is None else busy / prof["unprofiled_ms"]
    out["host_outside_ms"] = None if busy is None else (prof["wall_ms"] - busy) / steps
    out["device_events"] = prof["device_events"] / steps
    return out


def trace_line(what, tr) -> str:
    """One report line of a ``per_step`` trace."""
    if tr["busy_share"] is None:
        return f"{what}: device time not measured (no device event in the trace)"
    return (f"{what}: {tr['unprofiled_ms']:.4f} ms a step between CUDA events, device busy "
            f"{tr['busy_ms']:.4f} ms ({tr['busy_share_unprofiled']:.4f} of the step; "
            f"{tr['device_events']:.0f} device events, B1-B4 kernels "
            f"{tr['library_kernel_ms']:.4f} ms); under the trace {tr['wall_ms']:.4f} ms a "
            f"step, busy share {tr['busy_share']:.4f}, host outside "
            f"{tr['host_outside_ms']:.4f} ms")


def use(e, **kw):
    """Set ``e``'s per-call serving options (``fused``, ``temperature``,
    ``speculative``); the packs stay."""
    e.sc = dataclasses.replace(e.sc, **kw)
    return e


def graph_phase(cfg, engines):
    """Phase 7 over ``engines`` (``{"dense", "fp32", "int8", "int4"}``): the
    captured step's tokens against the eager loop's, greedy and sampled;
    the graph's launches (replays x the launches captured in one step)
    against the counted run's; tok/s of graph and eager in turns; a
    profiler trace of ``PROFILED_STEPS`` replays (and of as many eager steps
    on the fp32-value pack)."""
    prompts = prompts_for(cfg)
    steps = MAX_NEW - 1
    res = {}
    for route, e in engines.items():
        r = {"tok_per_s": {"graph": [], "eager": []}}
        for temp in (0.0, 1.0):
            g0 = use(e, fused=True, temperature=temp).graph_launches()
            graph = e.generate(prompts, max_new=MAX_NEW)
            g1 = e.graph_launches()
            eager = use(e, fused=False).generate(prompts, max_new=MAX_NEW)
            if temp == 0.0:  # the first turn: graph, eager
                r["tok_per_s"]["graph"].append(graph["tok_per_s"])
                r["tok_per_s"]["eager"].append(eager["tok_per_s"])
            tag = f"graph decode {route} {'sampled' if temp else 'greedy'}"
            if not (graph["finite"] and eager["finite"]):
                fail(f"{tag}: non-finite logits")
            if not np.array_equal(graph["tokens"], eager["tokens"]):
                fail(f"{tag}: graph tokens differ from the eager loop's at "
                     f"{np.argwhere(graph['tokens'] != eager['tokens'])[0].tolist()}")
            if temp == 0.0 and route != "dense":
                vd = "dense" if route == "fp32" else route
                got = {n: {k: v - g0.get(n, {}).get(k, 0) for k, v in c.items()}
                       for n, c in g1.items()}
                want = {name: {k: n * steps if k == vd else 0 for k in got[name]}
                        for name, n in (("vusa_packed_matmul", 4 * cfg.n_layers + 1),
                                        ("vusa_fused_mlp_matmul", cfg.n_layers))}
                if got != want:
                    fail(f"{tag}: graph launches {got} != expected {want}")
                r["graph_launches"] = {n: c[vd] for n, c in got.items()}
        turns = r["tok_per_s"]  # the second turn, reversed: eager, graph
        turns["eager"].append(use(e, temperature=0.0).generate(prompts, MAX_NEW)["tok_per_s"])
        turns["graph"].append(use(e, fused=True).generate(prompts, MAX_NEW)["tok_per_s"])
        r["ms_per_step"] = {k: [1e3 * BATCH / t for t in v] for k, v in turns.items()}
        with torch.no_grad():
            tok, cache = e.prime(prompts)
            r["trace_graph"] = per_step(profile_window(lambda: use(e, fused=True).decode_segment(
                tok, copy_cache(cache), PROFILED_STEPS)), PROFILED_STEPS)
            if route == "fp32":
                r["graph_structure"] = graph_structure(cfg, e)
                r["trace_eager"] = per_step(profile_window(lambda: use(e, fused=False)
                                                           .decode_segment(tok, copy_cache(cache),
                                                                           PROFILED_STEPS)),
                                            PROFILED_STEPS)
        use(e, fused=False)
        res[route] = r
    return res


def graph_structure(cfg, e) -> dict:
    """One packed decode step (B = ``BATCH``) captured in a CUDA graph in
    debug mode, its DOT dump written to ``chiprun_out/decode_step_graph.dot``
    and read: the graph's nodes and edges, and its kernel nodes of the B1-B4
    library by kernel.  They must be the step's planned CUDA launches
    (``planned_cuda_launches``): 49 row-packed and 12 fused-MLP kernels and
    one ordered sum for each call whose plan takes one, so the capture kept
    every launch of the library, its clusters included (the fused MLP's
    result depends on them, and the graph's tokens equal the eager
    loop's).  The dump shows no edge types: whether the capture kept the
    dependent launches' programmatic edges is not read here."""
    with torch.no_grad():
        tok, cache = e.prime(prompts_for(cfg))
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept for the dump
        graph.enable_debug_mode()
        with torch.cuda.graph(graph):
            lm_decode_step_packed(e.params, e.packed, tok, cache, cfg)
    path = ROOT / "chiprun_out" / "decode_step_graph.dot"
    path.parent.mkdir(exist_ok=True)
    graph.debug_dump(str(path))
    if not path.exists():
        fail("graph decode: the runtime wrote no DOT dump of the captured step")
    ids = [ln for ln in path.read_text().splitlines() if ln.startswith("| {ID | ")]
    out = {"dot": str(path.relative_to(ROOT)), "nodes": len(ids),
           "edges": path.read_text().count("->"),
           **{k: sum(k in ln for ln in ids) for k in LIBRARY_KERNELS}}
    planned = planned_cuda_launches(cfg, e.packed)
    want = {"row_packed_kernel": 4 * cfg.n_layers + 1, "fused_mlp_kernel": cfg.n_layers}
    want["sum_slices_kernel"] = sum(planned.values()) - sum(want.values())
    if {k: out[k] for k in LIBRARY_KERNELS} != want:
        fail(f"graph decode: the captured step holds library kernels "
             f"{ {k: out[k] for k in LIBRARY_KERNELS} }, the plan takes {want}")
    return out


def tiered(tree):
    """The tier structure of ``tests/test_spec_decode.py::_tiered`` on every
    matrix: the top 1 % of magnitudes kept, the next 14 % scaled by 0.03,
    zeros elsewhere, so a 99 %-sparse drafter keeps exactly the core."""
    if isinstance(tree, dict):
        return {k: tiered(v) for k, v in tree.items()}
    if tree.ndim < 2:
        return tree
    a = tree.abs()
    srt = a.flatten().sort(descending=True).values
    t1, t2 = (srt[max(int(f * a.numel()) - 1, 0)] for f in (0.01, 0.15))
    return torch.where(a >= t1, tree, torch.where(a >= t2, tree * 0.03, torch.zeros_like(tree)))


def spec_phase(cfg, raw, max_len):
    """Phase 8: ``vusa_edge`` at full width on ``tiered`` params (from the
    unpruned init ``raw``), B = 1, the drafter at ``DRAFT_SPARSITY``
    drafting ``DRAFT_K`` tokens a round, the verifier dense and packed
    with fp32 and with int8 values: speculative tokens against plain graph
    decode's, greedy and sampled; acceptance, rounds, tok/s in turns; on
    the packed routes one drafter step's and one verify's device time (a
    trace of 3 of each)."""
    params = tiered(raw)
    prompt = prompts_for(cfg)[:1]
    res, drafter = {}, None
    for route in ("fp32", "int8", "dense"):
        t0 = time.monotonic()
        e = Engine(cfg, params, ServeConfig(
            max_len=max_len, packed_weights=False if route == "dense" else "all",
            packed_values="int8" if route == "int8" else "bf16", speculative=drafter is None,
            draft_k=DRAFT_K, draft_sparsity=DRAFT_SPARSITY), device=DEVICE)
        # the drafter depends on the weights and DRAFT_SPARSITY alone: built
        # by the first engine, handed to the others
        drafter = e.draft_packed if drafter is None else drafter
        e._draft_packed = drafter
        r = {"build_s": time.monotonic() - t0,
             "draft_pack_bytes": pack_bytes(e.draft_packed),
             "verify_pack_bytes": None if e.packed is None else pack_bytes(e.packed),
             "tok_per_s": {"speculative": [], "plain": []}}
        for temp in (0.0, 1.0):
            spec = use(e, speculative=True, temperature=temp).generate(prompt, MAX_NEW)
            plain = use(e, speculative=False).generate(prompt, MAX_NEW)
            tag = f"speculative {route} {'sampled' if temp else 'greedy'}"
            if not (spec["finite"] and plain["finite"]):
                fail(f"{tag}: non-finite logits")
            if not np.array_equal(spec["tokens"], plain["tokens"]):
                fail(f"{tag}: speculative tokens differ from plain decode's at "
                     f"{np.argwhere(spec['tokens'] != plain['tokens'])[0].tolist()}")
            r["sampled" if temp else "greedy"] = {
                k: spec[k] for k in ("spec_rounds", "spec_proposed", "spec_accepted",
                                     "acceptance_rate")}
            if temp == 0.0:  # the first turn: speculative, plain
                r["tok_per_s"]["speculative"].append(spec["tok_per_s"])
                r["tok_per_s"]["plain"].append(plain["tok_per_s"])
        turns = r["tok_per_s"]  # the second turn, reversed: plain, speculative
        turns["plain"].append(use(e, temperature=0.0).generate(prompt, MAX_NEW)["tok_per_s"])
        turns["speculative"].append(use(e, speculative=True).generate(prompt, MAX_NEW)
                                    ["tok_per_s"])
        if e.packed is None:
            res[route] = r
            continue
        with torch.no_grad():
            tok, cache = e.prime(prompt)
            seq = tok.repeat(1, VERIFY_ROWS)
            for name, pk, x in (("drafter_step", e.draft_packed, tok),
                                ("verify", e.packed, seq)):
                r[name] = per_step(profile_window(lambda pk=pk, x=x: [
                    lm_decode_step_packed(e.params, pk, x, c, cfg)
                    for c in [copy_cache(cache)] for _ in range(3)]), 3)
        res[route] = r
    return res


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on the card")
    strict_fp32()  # TF32 off: dense fp32 products are true fp32
    t_start = time.monotonic()
    card = card_line()
    print(card, flush=True)

    t0 = time.monotonic()
    reports = build.build(force=True)
    for name, rep in reports.items():
        print(f"--- ptxas report: {name}.cu ---\n{rep.strip()}", flush=True)
    print(f"built {list(reports)} in {time.monotonic() - t0:.1f}s", flush=True)

    cfg = get_config("vusa_edge")
    t0 = time.monotonic()
    raw = build_model(cfg).init(0, device=DEVICE)  # unpruned: phase 8 tiers it
    params = prune_tree(raw, cfg.sparsity)
    max_len = PROMPT + MAX_NEW + 8
    # fused=False: the counted runs and the phases before 7 take the eager loop
    eng = Engine(cfg, params, ServeConfig(max_len=max_len, packed_weights="all", fused=False),
                 device=DEVICE)
    qengs = {route: Engine(cfg, params, ServeConfig(max_len=max_len, packed_weights="all",
                                                    fused=False,
                                                    packed_values=route), device=DEVICE)
             for route in QDTYPES}
    engines = {"dense": eng, **qengs}
    ratios = {route: packed_byte_ratios(e.packed) for route, e in engines.items()}
    sizes = {route: pack_bytes(e.packed) for route, e in engines.items()}
    print(f"vusa_edge init+prune+pack (3 packs) {time.monotonic() - t0:.1f}s; pack bytes per "
          "decode step (byte ratio vs dense fp32): " + ", ".join(
              f"{'fp32' if r == 'dense' else r} values {sizes[r]} ({ratios[r]['total']:.4f})"
              for r in engines), flush=True)

    floor_ms = Timer()(lambda: empty_kernel(DEVICE))
    print(f"launch floor: an empty kernel takes {floor_ms:.4f} ms under the kernel timer (L2 "
          f"flushed, device spin of {SPIN_CYCLES} cycles, CUDA events)", flush=True)
    records, step = kernel_phase(cfg, {r: e.packed for r, e in engines.items()},
                                 np.random.default_rng(0))
    for r in records:
        worst = max(c["rel_err"] for c in r["cases"])
        line = f"kernel check {r['name']}: ok, worst error {worst:.3g} of max |plain|"
        if "timing" in r:
            t = r["timing"]
            line += (f"; B={t['B']} {t['x']}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, "
                     f"library {t['library_ms']:.4f}, bound {t['bound_ms']:.4f} by {t['bound_by']})")
        print(line, flush=True)

    res = model_phase(cfg, params, eng)
    main_, b16, f32 = res["main"], res["bf16"], res["fp32"]
    print(f"main path: launches {res['launches']} over {MAX_NEW - 1} decode steps, CUDA launches "
          f"per call {res['cuda_launches_per_call']} (counted, equal to the plan); bf16 packed "
          f"{main_['tok_per_s']:.1f} tok/s (decode {main_['decode_s']:.4f} s, prefill "
          f"{main_['prefill_s']:.4f} s, peak memory {main_['peak_bytes']} bytes), dense "
          f"{b16['dense_tok_per_s']:.1f} tok/s, token agreement {b16['token_agreement']:.4f}, "
          f"first-step logit gap {b16['first_step_logit_gap']:.4g} "
          f"({b16['first_step_logit_gap_rel']:.3g} of max)", flush=True)
    for r in (f32, res["fp32_depth_cut"]):
        print(f"fp32 {r['layers']} layers: packed {r['packed_tok_per_s']:.1f} tok/s, dense "
              f"{r['dense_tok_per_s']:.1f} tok/s; packed vs dense: token agreement "
              f"{r['token_agreement']:.4f}, first-step logit gap {r['first_step_logit_gap']:.4g} "
              f"({r['first_step_logit_gap_rel']:.3g} of max); witness (dense, ff lanes "
              f"permuted) vs dense: token agreement {r['witness_token_agreement']:.4f}, "
              f"first-step logit gap {r['witness_first_step_logit_gap']:.4g} "
              f"({r['witness_first_step_logit_gap_rel']:.3g} of max)", flush=True)

    quant = quantized_phase(cfg, params, qengs)
    for route, q in quant.items():
        print(f"{route} main path: launches {q['launches']} over {MAX_NEW - 1} decode steps, "
              f"CUDA launches per call {q['cuda_launches_per_call']} (counted); "
              f"{q['tok_per_s']:.1f} tok/s (fp32-value pack {main_['tok_per_s']:.1f}, dense "
              f"{b16['dense_tok_per_s']:.1f}; decode {q['decode_s']:.4f} s, peak memory "
              f"{q['peak_bytes']} bytes); pack bytes per step {q['pack_bytes_per_step']}, byte "
              f"ratio {q['byte_ratio']:.4f}", flush=True)
        for r in (q["fp32"], q["fp32_depth_cut"]):
            witness = (f32 if r["layers"] == cfg.n_layers else res["fp32_depth_cut"])
            print(f"fp32 {r['layers']} layers, {route} packed vs dense on qdq params from one "
                  f"primed cache: token agreement {r['token_agreement']:.4f}, first-step logit "
                  f"gap {r['first_step_logit_gap']:.4g} ({r['first_step_logit_gap_rel']:.3g} of "
                  f"max); witness token agreement {witness['witness_token_agreement']:.4f}",
                  flush=True)

    turns = interleaved_tok_per_s(cfg, engines)
    print("decode tok/s taken in turns (B=4, bf16 activations): " + "; ".join(
        f"{'fp32' if r == 'dense' else r} values {sorted(v)}" for r, v in turns.items()),
        flush=True)

    t0 = time.monotonic()
    paper = paper_phase()
    for name, m in paper.items():
        b5, b6, sim = m["vusa_spmm"], m["dense_matmul"], m["simulator"]
        print(f"paper workloads {name} ({m['gemms']} GEMMs, {m['rate']:.0%} pruned, one image): "
              f"launches {m['launches']}; B5 vusa_spmm {b5['ms']:.4f} ms, B6 dense_matmul "
              f"{b6['ms']:.4f} ms, B5/B6 {b5['ms'] / b6['ms']:.4f}; plain {b5['plain_ms']:.4f} / "
              f"{b6['plain_ms']:.4f} ms, library torch.matmul fp32 {b5['library_ms']:.4f} ms, "
              f"bound {b5['bound_ms']:.4f} / {b6['bound_ms']:.4f} ms by {b5['bound_by']} / "
              f"{b6['bound_by']} (3xTF32; fp32 at 67 TFLOP/s {b5['bound_fp32_ms']:.4f} / "
              f"{b6['bound_fp32_ms']:.4f}); CUDA launches per call "
              f"{b5['cuda_launches_per_call']:.4f} / {b6['cuda_launches_per_call']:.4f}; fp32 "
              f"operations B5 {b5['flops']} B6 {b6['flops']} logical {m['logical_flops']}; "
              f"sum of compression {m['compression_sum']:.4f}, packed / dense bytes "
              f"{m['byte_ratio']:.4f}, mean virtual growth {m['virtual_growth_mean']:.4f}; "
              f"simulator VUSA 3x6 {sim['vusa_3x6']} cycles, standard 3x6 "
              f"{sim['standard_3x6']}, VUSA / standard {sim['ratio']:.4f}",
              flush=True)
        for gname, grp in m["layer_groups"].items():
            print(f"paper workloads {name} {gname} ({grp['gemms']} GEMMs): " + ", ".join(
                f"{key} {grp[key]['ms']:.4f} ms ({grp[key]['logical_tflop_per_s']:.2f} logical "
                "TFLOP/s)" for key in ("vusa_spmm", "dense_matmul", "library")), flush=True)
    print(f"paper workloads phase {time.monotonic() - t0:.1f}s", flush=True)

    t0 = time.monotonic()
    dense_eng = Engine(cfg, params, ServeConfig(max_len=max_len, fused=False), device=DEVICE)
    graph = graph_phase(cfg, {"dense": dense_eng, "fp32": eng, **qengs})
    for route, g in graph.items():
        line = (f"graph decode {route}: graph tokens equal the eager loop's (greedy and "
                f"sampled); tok/s in turns graph {g['tok_per_s']['graph']}, eager "
                f"{g['tok_per_s']['eager']}; ms per step graph "
                f"{min(g['ms_per_step']['graph']):.4f}, eager "
                f"{min(g['ms_per_step']['eager']):.4f} (the better of 2)")
        if "graph_launches" in g:
            line += f"; graph launches {g['graph_launches']} (replays x captured)"
        print(line, flush=True)
        print(trace_line(f"graph decode {route}, {PROFILED_STEPS} replays", g["trace_graph"]),
              flush=True)
        if "graph_structure" in g:
            print(f"graph decode {route}, one step captured in debug mode: "
                  f"{g['graph_structure']}", flush=True)
        if "trace_eager" in g:
            print(trace_line(f"graph decode {route}, {PROFILED_STEPS} eager steps",
                             g["trace_eager"]), flush=True)
    print(f"graph decode phase {time.monotonic() - t0:.1f}s", flush=True)

    t0 = time.monotonic()
    spec = spec_phase(cfg, raw, max_len)
    for route, r in spec.items():
        g = r["greedy"]
        line = (f"speculative {route} (B=1, k={DRAFT_K}, drafter {DRAFT_SPARSITY:.0%} sparse, "
                f"{r['draft_pack_bytes']} pack bytes vs the verifier's {r['verify_pack_bytes']}): "
                f"tokens equal plain graph decode's (greedy and sampled); greedy acceptance "
                f"{g['acceptance_rate']:.4f} over {g['spec_rounds']} rounds "
                f"({g['spec_accepted']}/{g['spec_proposed']}), sampled "
                f"{r['sampled']['acceptance_rate']:.4f}; tok/s in turns speculative "
                f"{r['tok_per_s']['speculative']}, plain {r['tok_per_s']['plain']}; built in "
                f"{r['build_s']:.1f}s")
        if "verify" in r:
            d, v = r["drafter_step"], r["verify"]
            line += (f"; drafter step {d['library_kernel_ms']:.4f} ms in B1-B4 kernels "
                     f"({d['device_sum_ms']:.4f} ms all device), verify of {VERIFY_ROWS} tokens "
                     f"{v['library_kernel_ms']:.4f} ms ({v['device_sum_ms']:.4f} ms)")
        print(line, flush=True)
    print(f"speculative phase {time.monotonic() - t0:.1f}s", flush=True)

    replaces = {"vusa_packed_matmul": "src/repro/kernels/vusa_packed.py:129",
                "vusa_fused_mlp_matmul": "src/repro/kernels/vusa_packed.py:256",
                "vusa_packed_matmul_quantized": "src/repro/kernels/vusa_packed.py:142",
                "vusa_fused_mlp_matmul_quantized": "src/repro/kernels/vusa_packed.py:294"}
    launches = {"dense": res["launches"], **{r: q["launches"] for r, q in quant.items()}}
    cuda_per_call = {"dense": res["cuda_launches_per_call"],
                     **{r: q["cuda_launches_per_call"] for r, q in quant.items()}}

    def entry(name, route):
        wrapper = name.removesuffix("_quantized")
        st = step[route][name]
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/vusa_packed.cu",
                "replaces": replaces[name], "launches": launches[route][wrapper],
                "launches_per_step": launches[route][wrapper] / (MAX_NEW - 1),
                "graph_launches": graph["fp32" if route == "dense" else route][
                    "graph_launches"][wrapper],
                "cuda_launches_per_call": cuda_per_call[route][wrapper],
                "max_abs_err": st["max_abs_err"], "ms": st["ms"], "plain_ms": st["plain_ms"],
                "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
                "library_ms": st["library_ms"]}

    kernels = [entry("vusa_packed_matmul", "dense"), entry("vusa_fused_mlp_matmul", "dense")]
    for name in ("vusa_packed_matmul_quantized", "vusa_fused_mlp_matmul_quantized"):
        k = entry(name, "int8")
        k["value_dtype"] = "int8"
        k["int4"] = {key: v for key, v in entry(name, "int4").items()
                     if key not in ("name", "route", "source", "replaces")}
        kernels.append(k)
    keys = ("launches", "cuda_launches_per_call", "max_abs_err", "max_abs_err_bf16", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, replaced in (("vusa_spmm", "src/repro/kernels/vusa_spmm.py:34"),
                           ("dense_matmul", "src/repro/kernels/dense_matmul.py:21")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{name}.cu", "replaces": replaced,
                        **{k: paper["resnet18"][name][k] for k in keys},
                        "mobilenetv1": {k: paper["mobilenetv1"][name][k] for k in keys}})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "timer_spin_cycles": SPIN_CYCLES, "launch_floor_ms": floor_ms,
         "kernels": kernels,
         "kernels_note": "ms, plain_ms, library_ms and "
         "bound_ms summed over one decode step (48 projections + head; 12 MLPs) at B=4, bf16 "
         "activations; B1/B2 with fp32 values, B3/B4 int8 at top level and int4 under 'int4'; "
         "B1-B4's cuda_launches_per_call counted by the vusa_packed library over the counted "
         "main-path run, per wrapper call; B1-B4's graph_launches the launches of phase 7's "
         "greedy graph run: replays x the launches captured in one step; "
         "vusa_spmm/dense_matmul summed over the 21 GEMMs of one ResNet-18 image (MobileNetV1's "
         "28 under 'mobilenetv1'), their cuda_launches_per_call the mean over those GEMMs of the "
         "CUDA launches each library counted in the counted run (2 where the plan splits the "
         "reduction), their bound_ms with TF32 tensor-core operations over 495 TFLOP/s, three "
         "per logical fp32 product (3xTF32)",
         "records": records, "model": res, "quantized": quant, "tok_per_s_in_turns": turns,
         "paper_workloads": paper, "graph_decode": graph, "speculative": spec,
         "pack_bytes_per_step": sizes, "byte_ratios": ratios,
         "seconds": time.monotonic() - t_start}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch port.")
    ap.add_argument("--spin-cycles", type=int, default=SPIN_CYCLES,
                    help="the kernel timer's device spin before each timed call, in cycles")
    SPIN_CYCLES = ap.parse_args().spin_cycles
    main()
