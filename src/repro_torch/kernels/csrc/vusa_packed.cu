// VUSA row-packed matmul kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the four packed-matmul Pallas TPU kernels of the JAX package
// (repro/kernels/vusa_packed.py):
//   * vusa_packed_matmul, dense values     <- `_kernel` (+ `_reconstruct_onehot`
//     / `_reconstruct_loop`), called from `vusa_packed_matmul`;
//   * vusa_packed_matmul, int8/int4 values <- `_qkernel` (+ `_dequant`);
//   * vusa_fused_mlp_matmul, dense values  <- `_fused_mlp_kernel`
//     (+ `_matmul_packed_window`), called from `vusa_fused_mlp_matmul`;
//   * vusa_fused_mlp_matmul, int8/int4     <- `_fused_mlp_qkernel`.
// The quantized kernels are the float ones with another value kind: each
// slot's value is rebuilt as q * scale[window, row] where the slot is read,
// so only the quantized bytes ever come from device memory.
//
// What bounds them on this card: bytes, and at decode sizes latency.  At
// B <= 8 each packed slot (a value plus an int8 lane position) is read once
// and used for B multiply-adds, far below the ~20 fp32 operations per byte
// the H100 needs before its fp32 rate, let alone its tensor cores, becomes
// the limit.  The least time is the pack's bytes over 3.35 TB/s: every
// position, the value bytes of the occupied slots (4 or 2 for float values,
// 1 for int8, 1/2 for int4) and, for quantized packs, one fp32 scale per
// (window, row).  A 768 x 768 projection is about 0.2 us of bytes, so what
// decides its time is how many SMs work on it and how long each waits.
//
// Both kernels stream packed rows the same way, with the device functions
// of namespace `rowpk`:
// - Chunks of RKC = 32 consecutive packed rows of one window (their values
//   and positions are contiguous in the (T, R, S) layout) are copied into
//   shared-memory stages with cp.async, consecutive threads on consecutive
//   pieces, several chunks in flight before the first is used.  The copy
//   width (16, 8 or 4 bytes, or plain byte loads) is picked on the host
//   from the alignment of the pointers and of the chunk strides: an odd S
//   or a row count off the slice size takes narrower copies in the same
//   kernel.
// - The rebuild (`rebuild_chunk`), from shared memory: one thread per slot
//   (per four slots of a row when S is a multiple of 4, as the packer's S
//   is), into a zeroed (RKC, 128) fp32 tile (two tiles, so zeroing the next
//   one overlaps this one's use).  Each occupied slot stores its value
//   straight into its lane and checks that the slot before it is occupied
//   with a lower lane, as in every row the packer writes; a row that fails
//   the check (a lane may repeat) is rebuilt in slot order by one thread.
// - The multiply (`multiply_chunk`): 512 threads as (lane l, part h of
//   PARTS = 4 of the chunk's rows) hold their 8 weights in registers and
//   accumulate x[b, k] * W[k, l] for the batch rows that exist (a branch
//   uniform in the block skips the tile's missing rows), k ascending.
//
// The row-packed matmul (B1/B3), `row_packed_kernel`:
// - An ordered split of the reduction.  The host (kernels/row_plan.py)
//   cuts the K packed rows into `slices` slices of ROWS = 64 rows, from K
//   alone, and passes (slices, ROWS); the entry point refuses any other.
//   The grid is (T windows, slices, batch tiles of BT = 8 rows): 72 blocks
//   for a 768-wide projection, 3000 for the 32000-wide head.  With one
//   slice the block writes the output; else each writes an fp32 partial
//   (slices, B, T*m), and a second launch (sum_slices_kernel, a
//   programmatic dependent launch) sums them in slice order 0..slices-1.
// - A slice's two chunks go into NS = 2 stages, both in flight from the
//   start; the four parts of each output meet once, in the epilogue.
//
// The fused SwiGLU MLP (B2/B4), `fused_mlp_kernel`: silu(x @ Wg) * (x @ Wu)
// @ Wd, gate/up packed (T, K, S) over the ff windows and w_down packed
// transposed (T, D, Sd), its lanes the window's ff rows.
// - One thread block cluster of G = 8 blocks per (ff window t, batch tile):
//   192 blocks at T = 24, B <= 8.  The host (kernels/mlp_plan.py) cuts the
//   K gate/up rows and the D down rows into G ordered slices each (`rows`
//   and `down_rows`, multiples of RKC, from K and from D alone: 96 and 96
//   at K = D = 768) and passes (G, rows, down_rows); the entry point
//   refuses any other.
// - Block r streams its gate slice, its up slice and its down slice as one
//   sequence of chunks through a ring of NS = 4 stages (nine chunks at
//   768 / 3072: every down chunk is in flight while gate and up are
//   multiplied).  Its gate and up sums (four parts each, added in part
//   order) stay in its shared memory.
// - After a cluster barrier, each block reads the G blocks' gate and up
//   sums through distributed shared memory, adds them in rank order
//   0..G-1 and forms the window's h = silu(gate) * up (g / (1 + expf(-g))
//   * u) for its batch rows in shared memory: the (B, ff) hidden state
//   never reaches device memory.
// - Each block then gathers its down rows, a chunk at a time, one thread
//   per (row, batch row): out[b, c] = the sum over the row's slots, in slot
//   order, of v * h[b, position] (fmaf).  The block writes the window's
//   (B, D) partial; a second launch (sum_slices_kernel, a programmatic
//   dependent launch) sums the T partials in window order.  A block
//   arrives at a second cluster barrier (relaxed: no memory ordering) once
//   it has read the other blocks' sums and waits on it before it exits, so
//   its own sums stay alive until every block has read them.
// - What bounds it: each block's serial walk over its chunks (wait, zero,
//   rebuild, multiply, with barriers between), not the bytes, which stream
//   at a fraction of the card's rate; scripts/fused_mlp_phases.py times
//   the phases.  A kernel this size also runs faster with its copy loops
//   kept short (they are inlined at every issue).
//
// Contracts (the speculative-decoding slice relies on them):
//   * row b of an output never depends on B.  No block shape, slice size
//     or summation order changes with B: each plan is a function of the
//     pack shapes only (K for B1/B3; K and D for B2/B4); each sum over
//     packed rows runs in ascending k in each of four fixed parts per
//     chunk (fmaf) and adds the parts in order; B1/B3 then add the slices,
//     B2/B4 the cluster's slices in rank order and, after the down gather
//     in slot order, the windows in order;
//   * no float atomics: a split reduction is summed in a fixed order, by a
//     second kernel or through distributed shared memory;
//   * a dequantized value is exactly the fp32 product q * scale (__fmul_rn:
//     never contracted into an fma with the add that follows), as the plain
//     version and the host-side dequant compute it.
//
// Semantics kept from the reference's one-hot reconstruction: a row's slots
// add into their lanes in slot order (a repeated lane sums), idle slots
// (position -1) and positions outside [0, m) contribute nothing, and their
// values are never used, so a NaN in an idle slot stays out.  Padded ff
// lanes are exact no-ops: their gate and up sums are zero (silu(0) * 0 ==
// 0) and no down slot points at them.
//
// Launch accounting: every kernel launch that the CUDA runtime accepts adds
// one to `cuda_launches[entry]` (0 vusa_packed_matmul, 1
// vusa_fused_mlp_matmul, 2 vusa_packed_empty), read by
// vusa_packed_cuda_launches.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "ptx.cuh"

namespace cg = cooperative_groups;

namespace {

// Kernel launches accepted by the runtime, by entry point.
enum Entry { kPackedEntry = 0, kFusedEntry = 1, kEmptyEntry = 2, kEntries = 3 };
static std::atomic<unsigned long long> cuda_launches[kEntries];

constexpr int BT = 8;                 // batch rows per block
constexpr int MMAX = 128;             // widest window: int8 lane positions
constexpr int WS = MMAX + 1;          // smem row stride of h: column reads hit distinct banks

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

enum ValueKind { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt4 = 3 };

// ---------------------------------------------------------------------------
// Streaming packed rows: the device code both kernels share (see the header).
// ---------------------------------------------------------------------------
namespace rowpk {

constexpr int RNT = 512;  // threads per block
constexpr int RKC = 32;   // packed rows per chunk
constexpr int UNROLL = 3; // slots a thread rebuilds at once
constexpr int PARTS = RNT / MMAX;  // threads per lane, each over a part of a chunk's rows
constexpr int PART_ROWS = RKC / PARTS;
constexpr size_t SMEM_LIMIT = 232448;  // a block's dynamic shared memory on sm_90

static_assert(RNT == PARTS * MMAX && RKC % PARTS == 0, "PARTS threads per lane");
static_assert(PART_ROWS % 4 == 0 && (RKC * MMAX) % (4 * RNT) == 0 && RKC <= RNT,
              "16-byte x reads and zeroing");

// Copy n bytes from src to dst (shared) with every thread of the block, in
// pieces of vec bytes (cp.async; the last piece may be partial and reads
// only its valid bytes), or byte by byte with plain loads where vec is 1.
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const unsigned char* src, int n,
                                           int vec) {
  const int tid = threadIdx.x;
  // the loops are not unrolled: this code is inlined at every issue, and a
  // larger kernel runs slower
  if (vec == 16) {
#pragma unroll 1
    for (int i = 16 * tid; i < n; i += 16 * RNT)
      ptx::cp_async16(dst + i, src + i, min(16, n - i));
  } else if (vec == 8) {
#pragma unroll 1
    for (int i = 8 * tid; i < n; i += 8 * RNT) ptx::cp_async8(dst + i, src + i, min(8, n - i));
  } else if (vec == 4) {
#pragma unroll 1
    for (int i = 4 * tid; i < n; i += 4 * RNT) ptx::cp_async4(dst + i, src + i, min(4, n - i));
  } else {
#pragma unroll 1
    for (int i = tid; i < n; i += RNT) dst[i] = __ldg(src + i);
  }
}

// One pack as the kernels stream it: its (T, R, S) values (rbv bytes a
// row), positions and (T, R) scales, the copy widths of its two streams,
// and where its positions start in a stage (sv bytes after the values).
struct Stream {
  const unsigned char* vals;
  const float* scales;
  const int8_t* pos;
  int S, rbv, vvec, pvec, sv;
};

// Start copying the kc packed rows from flattened row `row` (t * R + r) of
// `p` into the stage st (values, then positions at st + sv).  The caller
// commits the group.
__device__ __forceinline__ void issue_chunk(unsigned char* st, const Stream& p, size_t row,
                                            int kc) {
  copy_chunk(st, p.vals + row * p.rbv, kc * p.rbv, p.vvec);
  copy_chunk(st + p.sv, reinterpret_cast<const unsigned char*>(p.pos) + row * p.S, kc * p.S,
             p.pvec);
}

// Slot s of row r of a chunk's values in shared memory, as fp32.
template <int VK>
__device__ __forceinline__ float slot_value(const unsigned char* v, int r, int s, int S,
                                            float scale) {
  if constexpr (VK == kF32) {
    return reinterpret_cast<const float*>(v)[r * S + s];
  } else if constexpr (VK == kBF16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(v)[r * S + s]);
  } else if constexpr (VK == kInt8) {
    return __fmul_rn(static_cast<float>(reinterpret_cast<const int8_t*>(v)[r * S + s]), scale);
  } else {
    // int4: slot 2i is byte i's low nibble, slot 2i+1 its high one, both
    // sign-extended.  The low nibble is shifted to the top of a 32-bit word
    // and back arithmetically: (b << 4) >> 4 on an int8_t would promote to
    // int first and not sign-extend.
    const int8_t b = reinterpret_cast<const int8_t*>(v)[r * (S >> 1) + (s >> 1)];
    const uint32_t low = static_cast<uint32_t>(static_cast<uint8_t>(b)) << 28;
    const int n = (s & 1) ? (static_cast<int>(b) >> 4) : (static_cast<int>(low) >> 28);
    return __fmul_rn(static_cast<float>(n), scale);
  }
}

// Slots i..i+3 of a chunk's values in shared memory (i a multiple of 4),
// as slot_value computes them.
template <int VK>
__device__ __forceinline__ void quad_values(const unsigned char* v, int i, float scale,
                                            float (&out)[4]) {
  if constexpr (VK == kF32) {
    const float4 f = *reinterpret_cast<const float4*>(v + 4 * i);
    out[0] = f.x, out[1] = f.y, out[2] = f.z, out[3] = f.w;
  } else if constexpr (VK == kBF16) {  // a bf16's bits are the top half of its fp32
    const uint2 u = *reinterpret_cast<const uint2*>(v + 2 * i);
    out[0] = __uint_as_float(u.x << 16), out[1] = __uint_as_float(u.x & 0xffff0000u);
    out[2] = __uint_as_float(u.y << 16), out[3] = __uint_as_float(u.y & 0xffff0000u);
  } else if constexpr (VK == kInt8) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(v + i);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[k] = __fmul_rn(static_cast<float>(static_cast<int8_t>(u >> (8 * k))), scale);
  } else {  // int4: bytes i/2 and i/2 + 1, low nibble first, as slot_value
    const uint32_t u = *reinterpret_cast<const uint16_t*>(v + i / 2);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t b = (u >> (8 * (k / 2))) & 0xffu;
      const int n = (k & 1) ? (static_cast<int>(static_cast<int8_t>(b)) >> 4)
                            : (static_cast<int>(b << 28) >> 28);
      out[k] = __fmul_rn(static_cast<float>(n), scale);
    }
  }
}

// Zero W tile `buf` of two (RKC, MMAX) tiles and its rows' flags.
__device__ __forceinline__ void zero_tile(float* W, int* flags, int buf) {
  const int tid = threadIdx.x;
  float4* w4 = reinterpret_cast<float4*>(W + buf * RKC * MMAX);
#pragma unroll
  for (int i = 0; i < RKC * MMAX / 4 / RNT; ++i)
    w4[tid + i * RNT] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < RKC) flags[buf * RKC + tid] = 0;
}

// Rebuild a chunk's kc packed rows (S slots each), staged at st (values;
// positions at st + sv), into the zeroed tile Wc with flags fl; sc holds
// the chunk's rows' scales (quantized kinds).  One thread per slot (per
// four slots of a row where S is a multiple of 4): slot i of the chunk is
// slot i % S of row i / S, and its position byte and value lie at i.  Each
// occupied slot stores 0 + v into its lane.  That is the sequential
// `W[q] += v` over the row's slots in order, bitwise, when the occupied
// slots come first with ascending lanes, as the packer writes them; a slot
// that finds otherwise flags its row, and one thread then rebuilds each
// flagged row in slot order (a repeated lane sums).  Every thread of the
// block calls it; it ends with a barrier.
template <int VK>
__device__ __forceinline__ void rebuild_chunk(float* Wc, int* fl, const unsigned char* st,
                                              int sv, const float* sc, int kc, int S, int m) {
  const int tid = threadIdx.x;
  const int8_t* ps = reinterpret_cast<const int8_t*>(st + sv);
  const float inv_s = 1.f / S;  // (i + 0.5) * inv_s rounds down to i / S for i < RKC * S
  const int n = kc * S;
  int redo = 0;
  if (S % 4 == 0) {
    // four slots of one row per thread: one 4-byte read of positions, one
    // read of four values
    for (int i = 4 * tid; i < n; i += 4 * RNT) {
      const int r = static_cast<int>((i + 0.5f) * inv_s), s = i - r * S;
      const uint32_t qs = *reinterpret_cast<const uint32_t*>(ps + i);
      float v[4];
      quad_values<VK>(st, i, sc[r], v);
      int prev = s > 0 ? ps[i - 1] : 0;
      bool bad = false;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = static_cast<int8_t>(qs >> (8 * u));
        if (q >= 0 && q < m) {
          Wc[r * MMAX + q] = __fadd_rn(v[u], 0.f);
          bad |= s + u > 0 && (prev < 0 || prev >= q);
        }
        prev = q;
      }
      if (bad) fl[r] = redo = 1;
    }
  } else {
    for (int i0 = tid; i0 < n; i0 += UNROLL * RNT) {
      // UNROLL slots at once, every load first (a slot past n reads the
      // last one again and stores nothing; an idle slot's value is loaded
      // but never used)
      int q[UNROLL], qp[UNROLL], r[UNROLL];
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = min(i0 + u * RNT, n - 1);
        r[u] = static_cast<int>((i + 0.5f) * inv_s);
        q[u] = ps[i];
        qp[u] = ps[max(i - 1, 0)];
        v[u] = slot_value<VK>(st, r[u], i - r[u] * S, S, sc[r[u]]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * RNT, s = i - r[u] * S;
        if (i < n && q[u] >= 0 && q[u] < m) {
          Wc[r[u] * MMAX + q[u]] = __fadd_rn(v[u], 0.f);
          if (s > 0 && (qp[u] < 0 || qp[u] >= q[u])) fl[r[u]] = redo = 1;
        }
      }
    }
  }
  if (__syncthreads_or(redo)) {
    if (tid < kc && fl[tid]) {
      float* Wr = Wc + tid * MMAX;
      for (int j = 0; j < MMAX; ++j) Wr[j] = 0.f;
      for (int s = 0; s < S; ++s) {
        const int q = ps[tid * S + s];
        if (q >= 0 && q < m) Wr[q] += slot_value<VK>(st, tid, s, S, sc[tid]);
      }
    }
    __syncthreads();
  }
}

// acc[b] += x[b, k] * w[k] over rows k = 0..PART_ROWS-1 (all, or those below
// ke), k ascending, for batch rows B0..B0+NB-1; the x rows (stride ld in
// shared memory) are read into registers first, so the loads overlap.
template <int B0, int NB, bool ALL>
__device__ __forceinline__ void multiply_rows(const float* xc, int ld,
                                              const float (&w)[PART_ROWS], int ke,
                                              float (&acc)[BT]) {
  float4 xv[NB][PART_ROWS / 4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int k4 = 0; k4 < PART_ROWS / 4; ++k4)
      xv[b][k4] = reinterpret_cast<const float4*>(xc + (B0 + b) * ld)[k4];
#pragma unroll
  for (int kk = 0; kk < PART_ROWS; ++kk) {
    if (ALL || kk < ke) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
        acc[B0 + b] = fmaf((&xv[b][kk / 4].x)[kk % 4], w[kk], acc[B0 + b]);
    }
  }
}

// multiply_rows for the nb batch rows that exist (a branch uniform in the
// block), four at a time.
template <bool ALL>
__device__ __forceinline__ void multiply(int nb, const float* xc, int ld,
                                         const float (&w)[PART_ROWS], int ke, float (&acc)[BT]) {
  static_assert(BT == 8, "the cases below");
  switch (nb) {
    case 1: multiply_rows<0, 1, ALL>(xc, ld, w, ke, acc); break;
    case 2: multiply_rows<0, 2, ALL>(xc, ld, w, ke, acc); break;
    case 3: multiply_rows<0, 3, ALL>(xc, ld, w, ke, acc); break;
    case 4: multiply_rows<0, 4, ALL>(xc, ld, w, ke, acc); break;
    default:
      multiply_rows<0, 4, ALL>(xc, ld, w, ke, acc);
      switch (nb) {
        case 5: multiply_rows<4, 1, ALL>(xc, ld, w, ke, acc); break;
        case 6: multiply_rows<4, 2, ALL>(xc, ld, w, ke, acc); break;
        case 7: multiply_rows<4, 3, ALL>(xc, ld, w, ke, acc); break;
        default: multiply_rows<4, 4, ALL>(xc, ld, w, ke, acc); break;
      }
  }
}

// This thread's part of a rebuilt chunk (kc rows in tile Wc) multiplied
// into acc: lane l = tid % MMAX, part h = tid / MMAX, rows h * PART_ROWS ..
// of the chunk, ascending.  xc: the chunk's first x column (row stride ld).
__device__ __forceinline__ void multiply_chunk(int nb, const float* xc, int ld, const float* Wc,
                                               int kc, int m, float (&acc)[BT]) {
  const int l = threadIdx.x % MMAX, h = threadIdx.x / MMAX;
  if (l < m) {
    const float* wc = Wc + h * PART_ROWS * MMAX + l;
    const int ke = kc - h * PART_ROWS;
    float w[PART_ROWS];
#pragma unroll
    for (int kk = 0; kk < PART_ROWS; ++kk) w[kk] = wc[kk * MMAX];
    if (ke >= PART_ROWS)
      multiply<true>(nb, xc + h * PART_ROWS, ld, w, ke, acc);
    else
      multiply<false>(nb, xc + h * PART_ROWS, ld, w, ke, acc);
  }
}

// out[i] = part[0][i] + part[1][i] + ... + part[slices-1][i], in that
// order, for n4 groups of four consecutive i (16-byte loads and stores)
// or, where V is 1, for n4 single i.  Launched as a programmatic dependent
// of the kernel that writes the partials: its launch overlaps that
// kernel's tail, and it waits for the partials before it reads them.
template <int V>
__global__ void sum_slices_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  size_t n4, int slices) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const Vec* p = reinterpret_cast<const Vec*>(part);
  Vec* o = reinterpret_cast<Vec*>(out);
  ptx::grid_dependency_wait();
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    Vec s = p[i];
    auto add = [&](const Vec& v) {
      if constexpr (V == 4) {
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      } else {
        s += v;
      }
    };
    // eight partials loaded before they are added, in order: the loads
    // overlap, the sums do not change
    int z = 1;
    for (; z + 8 <= slices; z += 8) {
      Vec v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = p[(size_t)(z + u) * n4 + i];
#pragma unroll
      for (int u = 0; u < 8; ++u) add(v[u]);
    }
    for (; z < slices; ++z) add(p[(size_t)z * n4 + i]);
    o[i] = s;
  }
}

// Launch sum_slices_kernel over n outputs as a programmatic dependent of
// the kernel last launched on `stream`; counted for `entry`.
cudaError_t launch_ordered_sum(const float* part, float* out, size_t n, int slices,
                               cudaStream_t stream, Entry entry) {
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(out) |
                                  reinterpret_cast<uintptr_t>(part)) % 16 == 0;
  const size_t n4 = vec ? n / 4 : n;
  const size_t want = (n4 + 255) / 256;
  cudaLaunchAttribute dependent[1];
  dependent[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(want < 4096 ? want : 4096));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cfg.attrs = dependent;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, vec ? sum_slices_kernel<4> : sum_slices_kernel<1>, part, out, n4,
                         slices);
  if (e == cudaSuccess) ++cuda_launches[entry];
  return e;
}

// The widest copy (16, 8 or 4 bytes; else 1, plain loads) that every
// chunk start p + t * t_stride + c * c_stride is aligned to.
int copy_width(const void* p, size_t t_stride, size_t c_stride) {
  size_t a = reinterpret_cast<uintptr_t>(p) | t_stride | c_stride | 16;
  a &= ~a + 1;  // the lowest set bit
  return a >= 4 ? static_cast<int>(a) : 1;
}

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// A pack's Stream for value kind VK: R rows a window, T windows.  Chunk
// starts lie at whole windows and whole RKC-row chunks (every slice size
// is a multiple of RKC), which the copy widths are picked for.
template <int VK>
Stream make_stream(const void* vals, const void* scales, const void* pos, int S, int R, int T) {
  Stream p{static_cast<const unsigned char*>(vals), static_cast<const float*>(scales),
           static_cast<const int8_t*>(pos), S, 0, 0, 0, 0};
  p.rbv = VK == kF32 ? 4 * S : VK == kBF16 ? 2 * S : VK == kInt8 ? S : S / 2;
  const size_t t_v = T > 1 ? (size_t)R * p.rbv : 0;  // window strides, where used
  const size_t t_p = T > 1 ? (size_t)R * S : 0;
  p.vvec = copy_width(vals, t_v, (size_t)RKC * p.rbv);
  p.pvec = copy_width(pos, t_p, (size_t)RKC * S);
  p.sv = static_cast<int>(align16((size_t)RKC * p.rbv));
  return p;
}

// Bytes of a stage that holds one chunk of `p`.
size_t stage_bytes(const Stream& p) { return p.sv + align16((size_t)RKC * p.S); }

// Opt `kern` in to SMEM_LIMIT bytes of dynamic shared memory, once per
// device: bit d of `done` for device d (two first calls racing both set
// the same attribute).
template <typename Kernel>
cudaError_t opt_in(Kernel kern, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_LIMIT);
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

// ---------------------------------------------------------------------------
// B1/B3: the row-packed matmul (see the header).
// ---------------------------------------------------------------------------
constexpr int ROWS = 64;  // packed rows per slice: the plan's slice size
constexpr int NS = 2;     // shared-memory stages: one per chunk of a slice
// W (two tiles and their rows' flags), the x tile, the slice's scales and
// the epilogue's parts
constexpr size_t SMEM_FIXED =
    (size_t)(2 * RKC * MMAX + 2 * RKC + BT * ROWS + ROWS + (PARTS - 1) * BT * MMAX) *
    sizeof(float);

static_assert(ROWS == NS * RKC, "a slice's chunks are in flight together");

// What the host passes besides x and the output.
struct Problem {
  int B, K, T, m;
  int slices;        // ordered reduction slices of ROWS rows (the plan)
  int stage;         // bytes of a stage (16-byte multiple)
  Stream pk;         // the pack
  float* part;       // (slices, B, T*m) fp32 partials, used when slices > 1
};

// One block per (window t, slice z, tile of <= BT batch rows); at most 64
// registers a thread, so two blocks share an SM.
template <typename XT, int VK>
__global__ void __launch_bounds__(RNT, 2)
    row_packed_kernel(const XT* __restrict__ x, float* __restrict__ out, const Problem pb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int t = blockIdx.x, z = blockIdx.y, b0 = blockIdx.z * BT;
  const int nb = min(BT, pb.B - b0);
  const int k0 = z * ROWS;
  const int rows = max(0, min(ROWS, pb.K - k0));  // packed rows of this slice
  const int nch = (rows + RKC - 1) / RKC;
  const size_t row0 = (size_t)t * pb.K + k0;  // flattened pack row of the slice's first row

  unsigned char* stages = smem_raw;  // NS (values, positions) stages
  float* W = reinterpret_cast<float*>(smem_raw + NS * pb.stage);  // two (RKC, MMAX) tiles
  float* xs = W + 2 * RKC * MMAX;                                  // (BT, ROWS)
  float* scl = xs + BT * ROWS;                                     // (ROWS)
  float* red = scl + ROWS;                                         // (PARTS - 1, BT, MMAX)
  int* flags = reinterpret_cast<int*>(red + (PARTS - 1) * BT * MMAX);  // two (RKC)

  // prologue: the slice's chunks in flight, one commit group each; the x
  // tile and the scales by plain loads meanwhile
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    if (c < nch)
      issue_chunk(stages + c * pb.stage, pb.pk, row0 + (size_t)c * RKC,
                  min(RKC, rows - c * RKC));
    ptx::cp_async_commit();
  }
  for (int i = tid; i < BT * ROWS; i += RNT) {
    const int b = i / ROWS, kk = i % ROWS;
    xs[i] = (b < nb && kk < rows) ? to_f32(x[(size_t)(b0 + b) * pb.K + k0 + kk]) : 0.f;
  }
  if constexpr (VK >= kInt8) {
    for (int i = tid; i < rows; i += RNT) scl[i] = pb.pk.scales[row0 + i];
  }
  zero_tile(W, flags, 0);

  const int l = tid % MMAX, h = tid / MMAX;
  float acc[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0.f;

  for (int c = 0; c < nch; ++c) {
    if (c == 0)  // chunk c has landed (this thread's copies) ...
      ptx::cp_async_wait<NS - 1>();
    else
      ptx::cp_async_wait<0>();
    __syncthreads();  // ... everyone's; chunk c - 1 is multiplied
    if (c + 1 < nch) zero_tile(W, flags, (c + 1) & 1);
    const int kc = min(RKC, rows - c * RKC);
    float* Wc = W + (c & 1) * RKC * MMAX;
    rebuild_chunk<VK>(Wc, flags + (c & 1) * RKC, stages + c * pb.stage, pb.pk.sv,
                      scl + c * RKC, kc, pb.pk.S, pb.m);
    multiply_chunk(nb, xs + c * RKC, ROWS, Wc, kc, pb.m, acc);
  }

  // epilogue: the parts' sums added in part order, into the output (one
  // slice) or this slice's partial
  if (h > 0 && l < pb.m) {
#pragma unroll
    for (int b = 0; b < BT; ++b)
      if (b < nb) red[((h - 1) * BT + b) * MMAX + l] = acc[b];
  }
  __syncthreads();
  if (h == 0 && l < pb.m) {
    const size_t ncols = (size_t)pb.T * pb.m;
    float* dst = pb.slices == 1 ? out : pb.part + (size_t)z * pb.B * ncols;
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      if (b < nb) {
        float v = acc[b];
#pragma unroll
        for (int p = 1; p < PARTS; ++p) v += red[((p - 1) * BT + b) * MMAX + l];
        dst[(size_t)(b0 + b) * ncols + (size_t)t * pb.m + l] = v;
      }
    }
  }
}

template <typename XT, int VK>
cudaError_t launch(const void* x, const void* values, const void* scales, const void* positions,
                   int S, void* out, Problem pb, cudaStream_t stream) {
  pb.pk = make_stream<VK>(values, scales, positions, S, pb.K, pb.T);
  const size_t stage = stage_bytes(pb.pk);
  const size_t smem = NS * stage + SMEM_FIXED;
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  pb.stage = static_cast<int>(stage);

  auto kern = row_packed_kernel<XT, VK>;
  // the most any S may need, once per instantiation and device
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t e = opt_in(kern, opted_in);
  if (e != cudaSuccess) return e;
  const dim3 grid(pb.T, pb.slices, (pb.B + BT - 1) / BT);
  kern<<<grid, RNT, smem, stream>>>(static_cast<const XT*>(x), static_cast<float*>(out), pb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ++cuda_launches[kPackedEntry];
  if (pb.slices == 1) return cudaSuccess;
  return launch_ordered_sum(pb.part, static_cast<float*>(out), (size_t)pb.B * pb.T * pb.m,
                            pb.slices, stream, kPackedEntry);
}

template <typename XT>
cudaError_t for_x(const void* x, const void* values, int kind, const void* scales,
                  const void* positions, int S, void* out, const Problem& pb, cudaStream_t st) {
  switch (kind) {
    case kF32: return launch<XT, kF32>(x, values, scales, positions, S, out, pb, st);
    case kBF16: return launch<XT, kBF16>(x, values, scales, positions, S, out, pb, st);
    case kInt8: return launch<XT, kInt8>(x, values, scales, positions, S, out, pb, st);
    case kInt4: return launch<XT, kInt4>(x, values, scales, positions, S, out, pb, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace rowpk

// ---------------------------------------------------------------------------
// B2/B4: the fused SwiGLU MLP (see the header).
// ---------------------------------------------------------------------------
namespace mlp {

using rowpk::PARTS;
using rowpk::RKC;
using rowpk::RNT;
using rowpk::Stream;

constexpr int G = 8;   // blocks per cluster: the plan's cluster size (the portable maximum)
constexpr int NS = 4;  // shared-memory stages of the chunk ring
enum Pack { kGate = 0, kUp = 1, kDown = 2 };

// Ordered slice size of n packed rows over the G blocks of a cluster: a
// multiple of RKC, at least RKC.
int slice_rows(int n) {
  const int per = (n + G - 1) / G;
  return std::max(1, (per + RKC - 1) / RKC) * RKC;
}

// What the host passes besides x.
struct Problem {
  int B, K, D, m;
  int rows, drows;   // the plan: gate/up rows and down rows per cluster rank
  int stage;         // bytes of a ring stage (16-byte multiple)
  Stream pk[3];      // gate, up, down_t
  float* part;       // (T, B, D) fp32 window partials
};

// Shared memory besides the ring: the two W tiles (later up's parts),
// gate's parts, h, the x tile, the three slices' scales and the tiles'
// flags.
size_t smem_fixed(int rows, int drows) {
  return (size_t)(2 * RKC * MMAX + PARTS * BT * MMAX + BT * WS + BT * rows + 2 * rows + drows +
                  2 * RKC) *
         sizeof(float);
}

// One cluster of G blocks per (ff window t, tile of <= BT batch rows);
// block r of the cluster takes the r-th slices (see the header).  At most
// 64 registers a thread, so two blocks share an SM.
template <typename XT, int VK>
__global__ void __launch_bounds__(RNT, 2)
    fused_mlp_kernel(const XT* __restrict__ x, const Problem pb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int r = static_cast<int>(cluster.block_rank());
  const int t = blockIdx.x / G, b0 = blockIdx.y * BT;
  const int nb = min(BT, pb.B - b0);
  const int k0 = r * pb.rows, d0 = r * pb.drows;
  const int krows = max(0, min(pb.rows, pb.K - k0));  // gate (and up) rows of this slice
  const int drows = max(0, min(pb.drows, pb.D - d0));  // down rows of this slice
  const int nk = (krows + RKC - 1) / RKC;             // chunks of gate, and of up
  const int nch = 2 * nk + (drows + RKC - 1) / RKC;   // gate's, then up's, then down's

  unsigned char* stages = smem_raw;                               // NS ring stages
  float* W = reinterpret_cast<float*>(smem_raw + NS * pb.stage);  // two (RKC, MMAX) tiles
  float* pu = W;                              // then up's parts, (PARTS, BT, MMAX)
  float* pg = W + 2 * RKC * MMAX;             // gate's parts, (PARTS, BT, MMAX)
  float* hs = pg + PARTS * BT * MMAX;         // (BT, WS): h of the window
  float* xs = hs + BT * WS;                   // (BT, rows)
  float* scl = xs + BT * pb.rows;             // gate (rows), up (rows), down (drows)
  int* flags = reinterpret_cast<int*>(scl + 2 * pb.rows + pb.drows);  // two (RKC)

  // chunk c of the sequence: its pack, its first row in the slice, its rows
  auto chunk_of = [&](int c, int& p, int& j0, int& kc) {
    p = c < nk ? kGate : c < 2 * nk ? kUp : kDown;
    j0 = (c - p * nk) * RKC;
    kc = min(RKC, (p == kDown ? drows : krows) - j0);
  };
  auto issue = [&](int c) {  // chunk c into stage c % NS, one commit group
    if (c < nch) {
      int p, j0, kc;
      chunk_of(c, p, j0, kc);
      const size_t row = (size_t)t * (p == kDown ? pb.D : pb.K) + (p == kDown ? d0 : k0) + j0;
      rowpk::issue_chunk(stages + (c % NS) * pb.stage, pb.pk[p], row, kc);
    }
    ptx::cp_async_commit();
  };

  // prologue: NS chunks in flight; the x tile and the slices' scales by
  // plain loads meanwhile
#pragma unroll 1
  for (int c = 0; c < NS; ++c) issue(c);
  for (int i = tid; i < BT * pb.rows; i += RNT) {
    const int b = i / pb.rows, kk = i % pb.rows;
    xs[i] = (b < nb && kk < krows) ? to_f32(x[(size_t)(b0 + b) * pb.K + k0 + kk]) : 0.f;
  }
  if constexpr (VK >= kInt8) {
    for (int i = tid; i < krows; i += RNT) {
      scl[i] = pb.pk[kGate].scales[(size_t)t * pb.K + k0 + i];
      scl[pb.rows + i] = pb.pk[kUp].scales[(size_t)t * pb.K + k0 + i];
    }
    for (int i = tid; i < drows; i += RNT)
      scl[2 * pb.rows + i] = pb.pk[kDown].scales[(size_t)t * pb.D + d0 + i];
  }
  rowpk::zero_tile(W, flags, 0);

  const int l = tid % MMAX, h = tid / MMAX;
  float acc[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0.f;
  auto park = [&](float* dst) {  // this thread's sums into its (h, b, l) slots
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      dst[(h * BT + b) * MMAX + l] = acc[b];
      acc[b] = 0.f;
    }
  };
  if (nk == 0) park(pg);  // no gate rows: gate's parts are zeros

  // gate, then up: rebuild and multiply chunk by chunk
  for (int c = 0; c < 2 * nk; ++c) {
    ptx::cp_async_wait<NS - 1>();  // chunk c has landed (this thread's copies) ...
    __syncthreads();               // ... everyone's; chunk c - 1 is multiplied
    if (c + 1 < 2 * nk) rowpk::zero_tile(W, flags, (c + 1) & 1);
    int p, j0, kc;
    chunk_of(c, p, j0, kc);
    float* Wc = W + (c & 1) * RKC * MMAX;
    rowpk::rebuild_chunk<VK>(Wc, flags + (c & 1) * RKC, stages + (c % NS) * pb.stage,
                             pb.pk[p].sv, scl + p * pb.rows + j0, kc, pb.pk[p].S, pb.m);
    issue(c + NS);  // the stage is rebuilt: refill it
    rowpk::multiply_chunk(nb, xs + j0, pb.rows, Wc, kc, pb.m, acc);
    if (c == nk - 1) park(pg);
  }
  __syncthreads();  // every multiply is done: the W tiles take up's parts
  park(pu);
  __syncthreads();
  // the block's gate and up sums: the parts added in part order, into part 0
  for (int i = tid; i < BT * MMAX; i += RNT) {
    float g = pg[i], u = pu[i];
#pragma unroll
    for (int q = 1; q < PARTS; ++q) {
      g += pg[q * BT * MMAX + i];
      u += pu[q * BT * MMAX + i];
    }
    pg[i] = g;
    pu[i] = u;
  }
  cluster.sync();  // every block's sums are written

  // h of the window: the cluster's sums added in rank order 0..G-1
  for (int i = tid; i < BT * MMAX; i += RNT) {
    const int b = i / MMAX, ll = i % MMAX;
    if (b < nb && ll < pb.m) {
      float gv[G], uv[G];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        gv[q] = cluster.map_shared_rank(pg, q)[i];
        uv[q] = cluster.map_shared_rank(pu, q)[i];
      }
      float g = gv[0], u = uv[0];
#pragma unroll
      for (int q = 1; q < G; ++q) {
        g += gv[q];
        u += uv[q];
      }
      hs[b * WS + ll] = g / (1.f + expf(-g)) * u;
    }
  }

  // this block's reads of the other blocks' sums are done (their values are
  // in hs): arrive now, wait before leaving
  ptx::cluster_arrive_relaxed();

  // down: each (row, batch row) gathers h over the row's slots in slot order
  const Stream& dn = pb.pk[kDown];
  for (int c = 2 * nk; c < nch; ++c) {
    ptx::cp_async_wait<NS - 1>();
    __syncthreads();  // chunk c has landed; h is written
    int p, j0, kc;
    chunk_of(c, p, j0, kc);
    const unsigned char* st = stages + (c % NS) * pb.stage;
    const int8_t* ps = reinterpret_cast<const int8_t*>(st + dn.sv);
    const float* sc = scl + 2 * pb.rows + j0;
    const int S = dn.S;
    for (int i = tid; i < kc * BT; i += RNT) {
      const int row = i / BT, b = i % BT;
      if (b >= nb) continue;
      const float* hb = hs + b * WS;
      float a = 0.f;
      if (S % 4 == 0) {
        for (int s = 0; s < S; s += 4) {
          const uint32_t qs = *reinterpret_cast<const uint32_t*>(ps + row * S + s);
          float v[4];
          rowpk::quad_values<VK>(st, row * S + s, sc[row], v);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int q = static_cast<int8_t>(qs >> (8 * u));
            if (q >= 0 && q < pb.m) a = fmaf(v[u], hb[q], a);
          }
        }
      } else {
        for (int s = 0; s < S; ++s) {
          const int q = ps[row * S + s];
          if (q >= 0 && q < pb.m)
            a = fmaf(rowpk::slot_value<VK>(st, row, s, S, sc[row]), hb[q], a);
        }
      }
      pb.part[((size_t)t * pb.B + b0 + b) * pb.D + d0 + j0 + row] = a;
    }
    if (c + NS < nch) {
      __syncthreads();  // the stage is read: refill it
      issue(c + NS);
    } else {
      ptx::cp_async_commit();  // one (empty) group per chunk, as above
    }
  }
  ptx::cluster_wait();  // no block leaves while another may still read its sums
}

template <typename XT, int VK>
cudaError_t launch(const void* x, const void* const (&vals)[3], const void* const (&scales)[3],
                   const void* const (&pos)[3], const int (&S)[3], void* out, Problem pb, int T,
                   cudaStream_t stream) {
  size_t stage = 0;
  for (int p = 0; p < 3; ++p) {
    pb.pk[p] = rowpk::make_stream<VK>(vals[p], scales[p], pos[p], S[p], p == kDown ? pb.D : pb.K,
                                      T);
    stage = std::max(stage, rowpk::stage_bytes(pb.pk[p]));
  }
  const size_t smem = NS * stage + smem_fixed(pb.rows, pb.drows);
  if (smem > rowpk::SMEM_LIMIT) return cudaErrorInvalidValue;
  pb.stage = static_cast<int>(stage);

  auto kern = fused_mlp_kernel<XT, VK>;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t e = rowpk::opt_in(kern, opted_in);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = G;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * T, (pb.B + BT - 1) / BT);
  cfg.blockDim = dim3(RNT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const XT*>(x), pb);
  if (e != cudaSuccess) return e;
  ++cuda_launches[kFusedEntry];
  return rowpk::launch_ordered_sum(pb.part, static_cast<float*>(out), (size_t)pb.B * pb.D, T,
                                   stream, kFusedEntry);
}

template <typename XT>
cudaError_t for_x(const void* x, int kind, const void* const (&vals)[3],
                  const void* const (&scales)[3], const void* const (&pos)[3], const int (&S)[3],
                  void* out, const Problem& pb, int T, cudaStream_t st) {
  switch (kind) {
    case kF32: return launch<XT, kF32>(x, vals, scales, pos, S, out, pb, T, st);
    case kBF16: return launch<XT, kBF16>(x, vals, scales, pos, S, out, pb, T, st);
    case kInt8: return launch<XT, kInt8>(x, vals, scales, pos, S, out, pb, T, st);
    case kInt4: return launch<XT, kInt4>(x, vals, scales, pos, S, out, pb, T, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace mlp

__global__ void empty_kernel() {}

// Quantized kinds need scales, and int4 an even slot count (two per byte).
bool bad_values(int kind, const void* scales, int S) {
  if (kind < kF32 || kind > kInt4) return true;
  if (kind >= kInt8 && scales == nullptr) return true;
  return kind == kInt4 && S % 2 != 0;
}

}  // namespace

extern "C" {

// x (B, K) fp32 or bf16; positions (T, K, S) int8; values by value_kind:
// 0 fp32 / 1 bf16 (T, K, S), 2 int8 (T, K, S), 3 int4 (T, K, S/2) nibble
// pairs; scales (T, K) fp32 for kinds 2 and 3 (ignored otherwise); out
// (B, T*m) fp32.  The plan (slices, rows) comes from the host
// (kernels/row_plan.py): rows must be ROWS and slices max(1, ceil(K /
// ROWS)); part holds slices * B * T*m fp32 when slices > 1.  Returns a
// cudaError_t (0 = launched).
int vusa_packed_matmul(const void* x, int x_bf16, const void* values, int value_kind,
                       const void* scales, const void* positions, void* out, void* part, int B,
                       int K, int T, int S, int m, int slices, int rows, void* stream) {
  if (m < 1 || m > MMAX || B < 0 || K < 0 || T < 0 || S < 0) return cudaErrorInvalidValue;
  if (bad_values(value_kind, scales, S)) return cudaErrorInvalidValue;
  const int want = K > rowpk::ROWS ? (K + rowpk::ROWS - 1) / rowpk::ROWS : 1;
  if (rows != rowpk::ROWS || slices != want || (slices > 1 && part == nullptr) ||
      slices > 65535 || (B + BT - 1) / BT > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return cudaSuccess;
  const rowpk::Problem pb{B, K, T, m, slices, 0, {}, static_cast<float*>(part)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return rowpk::for_x<__nv_bfloat16>(x, values, value_kind, scales, positions, S, out, pb, st);
  return rowpk::for_x<float>(x, values, value_kind, scales, positions, S, out, pb, st);
}

// x (B, K); gate/up (T, K, Sg/Su) packs with scales (T, K); down_t (T, D, Sd)
// with scales (T, D); all values of one value_kind (as above; scales
// ignored for float kinds); partial (T, B, D) fp32 scratch; out (B, D) fp32.
// The plan (cluster, rows, down_rows) comes from the host
// (kernels/mlp_plan.py): cluster must be G = 8, rows and down_rows the
// ordered slice sizes of K and of D (slice_rows).  Returns a cudaError_t.
int vusa_fused_mlp_matmul(const void* x, int x_bf16, int value_kind, const void* gv,
                          const void* gs, const void* gp, int Sg, const void* uv, const void* us,
                          const void* up, int Su, const void* dv, const void* ds, const void* dp,
                          int Sd, void* partial, void* out, int B, int K, int D, int T, int m,
                          int cluster, int rows, int down_rows, void* stream) {
  if (m < 1 || m > MMAX || B < 0 || K < 0 || D < 0 || T < 0 || Sg < 0 || Su < 0 || Sd < 0)
    return cudaErrorInvalidValue;
  if (bad_values(value_kind, gs, Sg) || bad_values(value_kind, us, Su) ||
      bad_values(value_kind, ds, Sd))
    return cudaErrorInvalidValue;
  if (cluster != mlp::G || rows != mlp::slice_rows(K) || down_rows != mlp::slice_rows(D) ||
      (B + BT - 1) / BT > 65535 || (size_t)mlp::G * T > 0x7fffffffu)
    return cudaErrorInvalidValue;
  if (B == 0 || D == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return cudaMemsetAsync(out, 0, (size_t)B * D * sizeof(float), st);
  if (partial == nullptr) return cudaErrorInvalidValue;
  const void* const vals[3] = {gv, uv, dv};
  const void* const scales[3] = {gs, us, ds};
  const void* const pos[3] = {gp, up, dp};
  const int S[3] = {Sg, Su, Sd};
  const mlp::Problem pb{B, K, D, m, rows, down_rows, 0, {}, static_cast<float*>(partial)};
  if (x_bf16)
    return mlp::for_x<__nv_bfloat16>(x, value_kind, vals, scales, pos, S, out, pb, T, st);
  return mlp::for_x<float>(x, value_kind, vals, scales, pos, S, out, pb, T, st);
}

// One launch of an empty kernel: the floor of a launch under a timer.
int vusa_packed_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++cuda_launches[kEmptyEntry];
  return e;
}

// CUDA launches the entry point `entry` (0 vusa_packed_matmul, 1
// vusa_fused_mlp_matmul, 2 vusa_packed_empty) has issued since the library
// was loaded; 0 for any other entry.
unsigned long long vusa_packed_cuda_launches(int entry) {
  return entry >= 0 && entry < kEntries ? cuda_launches[entry].load() : 0;
}

const char* vusa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
