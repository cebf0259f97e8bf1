#!/usr/bin/env python3
"""Where the fused SwiGLU MLP kernel (B2/B4) spends its time, on one card.

    python3 scripts/fused_mlp_phases.py [--variants base,nocompute,unrolled]
                                        [--clusters 5:4,4:18] [--stream]

Builds instrumented copies of ``src/repro_torch/kernels/csrc/vusa_packed.cu``
with ``nvcc`` (one per variant, all started together) into the gitignored
``src/repro_torch/kernels/build/phases/``: thread 0 of every block of
``fused_mlp_kernel`` records ``clock64()`` and ``%globaltimer`` at its start,
after the prologue, after the gate/up chunks, after the first cluster
barrier, after h and after the down chunks, and the cycles it spent waiting
for its chunks.  Each variant runs the MLP of one ``vusa_edge`` layer (d 768,
ff 3072, 85 % of random weights pruned, a = 16) with fp32 and int8 values
at B = 4, bf16 activations: the time per call with CUDA events (L2 flushed
and the device spun before each call, as ``chip_smoke.py``'s timer does),
the dense SwiGLU's time, and the per-phase means over the blocks of one
cold call.  Variants:

- ``base``: the kernel as it is;
- ``nocompute``: no rebuild and no multiply (wrong outputs): the floor of
  the chunk walk's loads and barriers;
- ``unrolled``: the copy loops and the prologue's issue loop unrolled, as
  the compiler does by default (a larger kernel);
- ``nosum``: no ordered window sum (wrong outputs): what its launch costs;
- ``syncexit``: a full ``cluster.sync()`` before the block exits, in place
  of the relaxed arrive after the reads of the other blocks' sums;
- ``sum1``: the ordered window sum loads one partial at a time, in place of
  eight before it adds them;
- ``--clusters G:NS,...``: G blocks per cluster with a ring of NS stages.

``--stream`` also times a plain kernel that reads 4, 13 and 50 MB with
16-byte loads, and an empty kernel, under the same timer.  The numbers are
for finding the bottleneck; ``chip_smoke.py`` times the kernels as they
ship.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, mlp_plan, ops, ref  # noqa: E402
from repro_torch.kernels import vusa_packed as packed_mod  # noqa: E402

CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "src/repro_torch/kernels/build/phases"
PHASES = ("prologue", "gate+up", "cluster barrier", "h (DSMEM)", "down")
NSTAMP = 6


def stamp(k: int) -> str:
    slot = "stamps[blockIdx.y * gridDim.x + blockIdx.x]"
    return ("  if (threadIdx.x == 0) { unsigned long long g; "
            'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g)); '
            f"{slot}[{k}] = clock64(); {slot}[{k + 8}] = g; }}\n")


def replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"instrumentation anchor not found once: {old[:60]!r}")
    return src.replace(old, new)


def instrument(src: str) -> str:
    """Stamps and wait counters in fused_mlp_kernel, and C entry points
    to read them and to run the plain streaming kernel."""
    src = replace_once(src, "namespace {\n\n// Kernel launches", """\
__device__ unsigned long long stamps[65536][16];
__global__ void stream_kernel(const float4* __restrict__ a, size_t n4, float* out) {
  float s = 0.f;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = __ldcg(a + i);
    s += v.x + v.y + v.z + v.w;
  }
  if (s == 12345.f) out[0] = s;
}
namespace {

// Kernel launches""")
    i = src.index("fused_mlp_kernel(const XT* __restrict__ x, const Problem pb) {")
    body = src[i:]
    body = replace_once(body, "  cg::cluster_group cluster = cg::this_cluster();\n",
                        "  cg::cluster_group cluster = cg::this_cluster();\n" + stamp(0)
                        + "  long long waited = 0, w0 = 0;\n")
    body = replace_once(body, "  const int l = tid % MMAX, h = tid / MMAX;\n  float acc[BT];",
                        stamp(1) + "  const int l = tid % MMAX, h = tid / MMAX;\n  float acc[BT];")
    wait = ("    ptx::cp_async_wait<NS - 1>();  // chunk c has landed (this thread's copies) ...\n"
            "    __syncthreads();               // ... everyone's; chunk c - 1 is multiplied\n")
    body = replace_once(body, wait, "    w0 = clock64();\n" + wait
                        + "    waited += clock64() - w0;\n")
    sync1 = "  cluster.sync();  // every block's sums are written\n"
    body = replace_once(body, sync1, stamp(2) + sync1 + stamp(3))
    down = "  // down: each (row, batch row)"
    body = replace_once(body, down, stamp(4) + down)
    dwait = ("    ptx::cp_async_wait<NS - 1>();\n"
             "    __syncthreads();  // chunk c has landed; h is written\n")
    body = replace_once(body, dwait, "    w0 = clock64();\n" + dwait
                        + "    waited += clock64() - w0;\n")
    last = body.rindex("\n", 0, body.index("// no block leaves")) + 1  # the exit barrier
    body = (body[:last] + stamp(5) + "  if (threadIdx.x == 0) stamps[blockIdx.y * gridDim.x + "
            "blockIdx.x][7] = waited;\n" + body[last:])
    return src[:i] + body + """
extern "C" int phases_read(unsigned long long* dst, int n) {
  return cudaMemcpyFromSymbol(dst, stamps, (size_t)n * 16 * 8);
}
extern "C" int phases_stream(const void* a, size_t n4, void* out, int blocks, void* stream) {
  stream_kernel<<<blocks, 512, 0, (cudaStream_t)stream>>>((const float4*)a, n4, (float*)out);
  return cudaGetLastError();
}
"""


def nocompute(src: str) -> str:
    old = """    rowpk::rebuild_chunk<VK>(Wc, flags + (c & 1) * RKC, stages + (c % NS) * pb.stage,
                             pb.pk[p].sv, scl + p * pb.rows + j0, kc, pb.pk[p].S, pb.m);
    issue(c + NS);  // the stage is rebuilt: refill it
    rowpk::multiply_chunk(nb, xs + j0, pb.rows, Wc, kc, pb.m, acc);"""
    return replace_once(src, old, "    __syncthreads();\n    issue(c + NS);")


def unrolled(src: str) -> str:
    loop = r"#pragma unroll 1(  //[^\n]*)?\n(\s+for \(int i = (16 \* |8 \* |4 \* )?tid; i < n;)"
    src = re.sub(loop, r"\2", src)
    return replace_once(src, "#pragma unroll 1\n  for (int c = 0; c < NS; ++c) issue(c);",
                        "#pragma unroll\n  for (int c = 0; c < NS; ++c) issue(c);")


def nosum(src: str) -> str:
    old = """  ++cuda_launches[kFusedEntry];
  return rowpk::launch_ordered_sum("""
    return replace_once(src, old, """  ++cuda_launches[kFusedEntry];
  if (T > 0) return cudaSuccess;
  return rowpk::launch_ordered_sum(""")


def syncexit(src: str) -> str:
    src = replace_once(src, "  ptx::cluster_arrive_relaxed();\n", "")
    return replace_once(src, "  ptx::cluster_wait();  // no block leaves",
                        "  cluster.sync();  // no block leaves")


def sum1(src: str) -> str:
    old = """    int z = 1;
    for (; z + 8 <= slices; z += 8) {
      Vec v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = p[(size_t)(z + u) * n4 + i];
#pragma unroll
      for (int u = 0; u < 8; ++u) add(v[u]);
    }
    for (; z < slices; ++z) add(p[(size_t)z * n4 + i]);"""
    one = "    for (int z = 1; z < slices; ++z) add(p[(size_t)z * n4 + i]);"
    return replace_once(src, old, one)


def cluster_stages(g: int, ns: int):
    def edit(src: str) -> str:
        src = replace_once(src, "constexpr int G = 8;", f"constexpr int G = {g};")
        return replace_once(src, "constexpr int NS = 4;", f"constexpr int NS = {ns};")
    return edit


def start_build(name: str, src: str):
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        (d / h.name).write_text(h.read_text())
    (d / "k.cu").write_text(instrument(src))
    lib = d / "libphases.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(d / "k.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(lib_path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.vusa_fused_mlp_matmul.argtypes = [P, I, I, P, P, P, I, P, P, P, I, P, P, P, I, P, P,
                                          *[I] * 8, P]
    lib.vusa_fused_mlp_matmul.restype = I
    lib.vusa_error_string.argtypes = [I]
    lib.vusa_error_string.restype = ctypes.c_char_p
    lib.vusa_packed_empty.argtypes = [P]
    lib.phases_read.argtypes = [P, I]
    lib.phases_stream.argtypes = [P, ctypes.c_size_t, P, I, P]
    return lib


class Timer:
    """Microseconds per call, as chip_smoke.py's timer: an L2 flush (a
    128 MiB write) and a 10^6-cycle device spin before each call."""

    def __init__(self, dev):
        self.flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)

    def cold(self):
        self.flush.zero_()
        torch.cuda._sleep(1_000_000)

    def __call__(self, fn, iters=30):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            self.cold()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        ts = sorted(1e3 * s.elapsed_time(e) for s, e in events)
        return ts[0], ts[len(ts) // 2]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default="base,nocompute,unrolled")
    ap.add_argument("--clusters", default="", help="G:NS pairs, e.g. 5:4,4:18")
    ap.add_argument("--stream", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    src = (CSRC / "vusa_packed.cu").read_text()
    edits = {"base": lambda s: s, "nocompute": nocompute, "unrolled": unrolled, "nosum": nosum,
             "syncexit": syncexit, "sum1": sum1, "syncexit+sum1": lambda s: syncexit(sum1(s))}
    variants = {name: (edits[name], mlp_plan.CLUSTER) for name in args.variants.split(",") if name}
    for pair in filter(None, args.clusters.split(",")):
        g, ns = map(int, pair.split(":"))
        variants[f"cluster {g}, {ns} stages"] = (cluster_stages(g, ns), g)
    builds = {name: start_build(re.sub(r"\W+", "_", name), edit(src))
              for name, (edit, _) in variants.items()}

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    rng = np.random.default_rng(0)

    def sparse(k, c):
        return rng.standard_normal((k, c), dtype=np.float32) * (rng.random((k, c)) >= 0.85)

    w = (sparse(768, 3072), sparse(768, 3072), sparse(3072, 768))
    x = torch.from_numpy(rng.standard_normal((4, 768), dtype=np.float32)).to(dev, torch.bfloat16)
    timer = Timer(dev)
    packs = {}
    for vd in ("dense", "int8"):
        pg, pu = (ops.pack_linear_rows(m, device=dev, value_dtype=vd) for m in w[:2])
        pd = ops.pack_linear_rows_t(w[2], device=dev, value_dtype=vd)
        packs[vd] = (pg.values, pg.positions, pu.values, pu.positions, pd.values, pd.positions,
                     pg.scales, pu.scales, pd.scales)
        dense = [ref.unpack_dense(ref.dequantize_values(p.values, p.scales, vd), p.positions)
                 [:, : p.c] for p in (pg, pu, pd)]
        wg, wu, wd = dense[0], dense[1], dense[2].T.contiguous()
        xf = x.float()
        lib_ms = timer(lambda: torch.nn.functional.silu(xf @ wg) * (xf @ wu) @ wd)
        print(f"dense SwiGLU ({vd} values, fp32 weights): min {lib_ms[0]:.2f} us, "
              f"median {lib_ms[1]:.2f} us")

    for name, (lib_path, proc) in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out[-4000:]}")
        sass = subprocess.run([str(Path(build.nvcc_path()).parent / "cuobjdump"), "-sass",
                               str(lib_path)], capture_output=True, text=True).stdout
        fused = [f for f in re.split(r"\n\s*Function : ", sass)
                 if "fused_mlp_kernelI13__nv_bfloat16Li0E" in f.split("\n")[0]]
        n_ins = sum(1 for line in fused[0].split("\n") if re.match(r"\s+/\*[0-9a-f]{4,}\*/", line))
        lib = load(lib_path)
        packed_mod._lib = lambda: lib
        mlp_plan.CLUSTER = variants[name][1]
        nblocks = mlp_plan.CLUSTER * 24
        print(f"== {name}: fused_mlp_kernel<bf16 x, fp32 values> {n_ins} SASS instructions")
        for vd, args_ in packs.items():
            def call():
                return packed_mod.vusa_fused_mlp_matmul(x, *args_, m=128, value_dtype=vd)

            err = float((call() - ref.vusa_fused_mlp_ref(x, *args_, m=128, value_dtype=vd))
                        .abs().max())
            t_min, t_med = timer(call)
            timer.cold()
            call()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (nblocks * 16))()
            lib.phases_read(ctypes.addressof(buf), nblocks)
            a = np.array(buf, dtype=np.float64).reshape(nblocks, 16)
            cyc, ns = a[:, :NSTAMP], a[:, 8:8 + NSTAMP]
            ghz = np.median((cyc[:, -1] - cyc[:, 0]) / np.maximum(ns[:, -1] - ns[:, 0], 1))
            us = np.diff(cyc, axis=1) / ghz / 1e3
            span = (ns[:, -1].max() - ns[:, 0].min()) / 1e3
            print(f"  {vd} values: {t_min:.2f} us per call (median {t_med:.2f}), max |err| "
                  f"{err:.3g}; blocks span {span:.2f} us; SM clock {ghz:.3f} GHz")
            print("    " + ", ".join(f"{p} {us[:, k].mean():.2f}" for k, p in enumerate(PHASES))
                  + f" us (block means); thread 0 waited {a[:, 7].mean() / ghz / 1e3:.2f} us "
                  "for its chunks")

    if args.stream:
        lib = load(next(iter(builds.values()))[0])
        stream = torch.cuda.current_stream().cuda_stream
        sink = torch.zeros(1, device=dev)
        for mb in (4, 13, 50):
            arr = torch.zeros(mb * 2**20 // 4, dtype=torch.float32, device=dev)
            for blocks in (132, 1056):
                t_min, _ = timer(lambda: lib.phases_stream(arr.data_ptr(), arr.numel() // 4,
                                                           sink.data_ptr(), blocks, stream))
                print(f"plain read of {mb} MB, {blocks} blocks of 512: {t_min:.2f} us "
                      f"({mb * 2**20 / t_min / 1e6:.2f} TB/s)")
        t_min, _ = timer(lambda: lib.vusa_packed_empty(stream))
        print(f"empty kernel: {t_min:.2f} us")


if __name__ == "__main__":
    main()
