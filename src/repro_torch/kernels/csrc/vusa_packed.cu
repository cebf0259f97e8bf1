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
// The quantized kernels are the float ones with another value loader: each
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
// The row-packed matmul (B1/B3), `row_packed_kernel`:
// - An ordered split of the reduction.  The host (kernels/row_plan.py)
//   cuts the K packed rows into `slices` slices of ROWS = 64 rows, from K
//   alone, and passes (slices, ROWS); the entry point refuses any other.
//   The grid is (T windows, slices, batch tiles of BT = 8 rows): 72 blocks
//   for a 768-wide projection, 3000 for the 32000-wide head.  With one
//   slice the block writes the output; else each writes an fp32 partial
//   (slices, B, T*m), and a second launch (sum_slices_kernel, a
//   programmatic dependent launch) sums them in slice order 0..slices-1.
// - Coalesced, overlapped loads.  A slice's rows of window t are contiguous
//   in the (T, K, S) layout: rows * S position bytes and rows * S * {4, 2,
//   1, 1/2} value bytes.  The block copies them in two chunks of RKC = 32
//   rows into NS = 2 shared-memory stages with cp.async, consecutive
//   threads on consecutive 16-byte pieces, both in flight from the start,
//   so the second chunk lands while the first is rebuilt and multiplied.
//   The copy width (16, 8 or 4 bytes, or plain byte loads) is picked on
//   the host from the alignment of the pointers and of the chunk strides:
//   an odd S or a K off the slice size takes narrower copies in the same
//   kernel.
// - The rebuild, from shared memory: one thread per slot (per four slots
//   of a row when S is a multiple of 4, as the packer's S is), into a zeroed
//   (RKC, 128) fp32 tile (two tiles, so zeroing the next one overlaps this
//   one's use; the zeroing is two 16-byte stores a thread).  Each occupied
//   slot stores its value straight into its lane and checks that the slot
//   before it is occupied with a lower lane, as in every row the packer
//   writes; a row that fails the check (a lane may repeat) is rebuilt in
//   slot order by one thread.
//   Then 512 threads as (lane l, part h of PARTS = 4 of the chunk's rows)
//   hold their 8 weights in registers and accumulate x[b, k] * W[k, l] for
//   the batch rows that exist (a branch uniform in the block skips the
//   tile's missing rows); the four parts meet once, in the epilogue.
//
// The fused SwiGLU MLP (B2/B4), `fused_mlp_partial_kernel`: one block per
// (ff window, batch tile) rebuilds gate, up and the window's w_down rows
// chunk by chunk in shared memory, keeps the (nb, m) hidden slice there,
// and writes the window's (B, D) partial; `sum_windows_kernel` sums the
// partials over windows in order.  It still loads without overlap.
//
// Contracts (the speculative-decoding slice relies on them):
//   * row b of an output never depends on B.  No block shape, slice size
//     or summation order changes with B: the plan is a function of K, each
//     output element of B1/B3 sums its slice's rows in ascending order in
//     each of four fixed parts per chunk (fmaf), adds the parts in order,
//     and the slices are summed in order; B2/B4 accumulate over k, then over the
//     window's lanes, in one fixed order, and sum the windows in order;
//   * no float atomics: a split reduction is summed by a second kernel in
//     a fixed order;
//   * a dequantized value is exactly the fp32 product q * scale (__fmul_rn:
//     never contracted into an fma with the add that follows), as the plain
//     version and the host-side dequant compute it.
//
// Semantics kept from the reference's one-hot reconstruction: a row's slots
// add into their lanes in slot order (a repeated lane sums), idle slots
// (position -1) and positions outside [0, m) contribute nothing, and their
// values are never used, so a NaN in an idle slot stays out.
//
// Launch accounting: every kernel launch that the CUDA runtime accepts adds
// one to `cuda_launches[entry]` (0 vusa_packed_matmul, 1
// vusa_fused_mlp_matmul, 2 vusa_packed_empty), read by
// vusa_packed_cuda_launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "ptx.cuh"

namespace {

// Kernel launches accepted by the runtime, by entry point.
enum Entry { kPackedEntry = 0, kFusedEntry = 1, kEmptyEntry = 2, kEntries = 3 };
static std::atomic<unsigned long long> cuda_launches[kEntries];

constexpr int NT = 256;               // threads per block
constexpr int KC = 128;               // packed rows rebuilt per chunk, one thread each
constexpr int BT = 8;                 // batch rows per block
constexpr int MMAX = 128;             // widest window: int8 lane positions
constexpr int WS = MMAX + 1;          // smem row stride: column reads hit distinct banks
constexpr int GROUPS = NT / MMAX;     // thread groups over the batch rows
constexpr int ACC = BT / GROUPS;      // outputs per thread
constexpr size_t SMEM_MATMUL = (size_t)(KC * WS + BT * KC) * sizeof(float);
constexpr size_t SMEM_FUSED = SMEM_MATMUL + (size_t)(BT * MMAX) * sizeof(float);

static_assert(NT >= KC, "one thread per rebuilt row");
static_assert(KC == MMAX, "the fused MLP's down chunk maps threads as the lanes do");
static_assert(NT % MMAX == 0 && BT % GROUPS == 0, "thread/output mapping");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Value loaders.  A pack's rows are its (window, row) pairs, flattened as
// t * R + r (R = K, or D for the fused MLP's transposed w_down pack); a
// loader's row(i) reads row i's slots as fp32.  The quantized loaders read
// row i's scale once and multiply each slot's integer by it.
enum ValueKind { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt4 = 3 };

template <typename VT>
struct FloatValues {  // (T, R, S) fp32 or bf16
  const VT* v;
  int S;
  struct Row {
    const VT* v;
    __device__ __forceinline__ float operator[](int s) const { return to_f32(v[s]); }
  };
  static FloatValues make(const void* v, const void*, int S) {
    return {static_cast<const VT*>(v), S};
  }
  __device__ __forceinline__ Row row(size_t i) const { return {v + i * S}; }
};

struct Int8Values {  // (T, R, S) int8, scales (T, R) fp32
  const int8_t* q;
  const float* scale;
  int S;
  struct Row {
    const int8_t* q;
    float scale;
    __device__ __forceinline__ float operator[](int s) const {
      return __fmul_rn(static_cast<float>(q[s]), scale);
    }
  };
  static Int8Values make(const void* q, const void* scale, int S) {
    return {static_cast<const int8_t*>(q), static_cast<const float*>(scale), S};
  }
  __device__ __forceinline__ Row row(size_t i) const { return {q + i * S, scale[i]}; }
};

struct Int4Values {  // (T, R, S/2) int8 nibble pairs, scales (T, R) fp32
  const int8_t* q;
  const float* scale;
  int S;  // logical slots (even); S/2 bytes per row
  struct Row {
    const int8_t* q;
    float scale;
    // slot 2i is byte i's low nibble, slot 2i+1 its high one, both
    // sign-extended.  The low nibble is shifted to the top of a 32-bit word
    // and back arithmetically: (b << 4) >> 4 on an int8_t would promote to
    // int first and not sign-extend.
    __device__ __forceinline__ float operator[](int s) const {
      const int8_t b = q[s >> 1];
      const uint32_t low = static_cast<uint32_t>(static_cast<uint8_t>(b)) << 28;
      const int n = (s & 1) ? (static_cast<int>(b) >> 4) : (static_cast<int>(low) >> 28);
      return __fmul_rn(static_cast<float>(n), scale);
    }
  };
  static Int4Values make(const void* q, const void* scale, int S) {
    return {static_cast<const int8_t*>(q), static_cast<const float*>(scale), S};
  }
  __device__ __forceinline__ Row row(size_t i) const { return {q + i * (S >> 1), scale[i]}; }
};

// Rebuild rows [row0, row0 + rows) of a pack (flattened row index) into W
// (rows x m, stride WS).  Thread r owns row r: it zeroes the row, then adds
// the row's slots into their lanes in slot order.  No two threads touch one
// row, so no atomics are needed and a repeated lane sums in a fixed order.
// A value is read only for an occupied slot.
template <typename Vals>
__device__ __forceinline__ void rebuild_rows(float* W, const Vals& vals,
                                             const int8_t* __restrict__ pos, size_t row0,
                                             int rows, int S, int m) {
  const int r = threadIdx.x;
  if (r < rows) {
    float* row = W + r * WS;
    for (int j = 0; j < m; ++j) row[j] = 0.f;
    const auto v = vals.row(row0 + r);
    const int8_t* p = pos + (row0 + r) * S;
    for (int s = 0; s < S; ++s) {
      const int q = p[s];
      if (q >= 0 && q < m) row[q] += v[s];
    }
  }
}

// acc[i] += sum_k x[b, k] * W_window[k, l] for this thread's outputs
// (b = g + GROUPS * i, l), k ascending.  x points at the tile's first row
// (nb rows of length K); the window's K pack rows start at row0.
template <typename XT, typename Vals>
__device__ void window_matmul(const XT* __restrict__ x, int nb, int K, const Vals& vals,
                              const int8_t* __restrict__ pos, size_t row0, int S, int m,
                              float* W, float* xs, float (&acc)[ACC]) {
  const int tid = threadIdx.x;
  const int l = tid % MMAX, g = tid / MMAX;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    for (int i = tid; i < BT * KC; i += NT) {
      const int b = i / KC, kk = i % KC;
      xs[i] = (b < nb && kk < kc) ? to_f32(x[(size_t)b * K + k0 + kk]) : 0.f;
    }
    rebuild_rows(W, vals, pos, row0 + k0, kc, S, m);
    __syncthreads();
    if (l < m) {
      for (int kk = 0; kk < kc; ++kk) {
        const float w = W[kk * WS + l];
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[i] = fmaf(xs[(g + GROUPS * i) * KC + kk], w, acc[i]);
      }
    }
    __syncthreads();
  }
}

// One block per (ff window t, batch tile): gate and up for the window, the
// (nb, m) slice of silu(gate) * up in shared memory, then the window's w_down
// rows (transposed pack: rows are the D outputs, lanes the window's ff rows)
// rebuilt in chunks of KC outputs.  Writes the window's (nb, D) partial.
template <typename XT, typename Vals>
__global__ void __launch_bounds__(NT)
fused_mlp_partial_kernel(const XT* __restrict__ x, const Vals gv, const int8_t* __restrict__ gp,
                         int Sg, const Vals uv, const int8_t* __restrict__ up, int Su,
                         const Vals dv, const int8_t* __restrict__ dp, int Sd,
                         float* __restrict__ partial, int B, int K, int D, int m) {
  extern __shared__ float smem[];
  float* W = smem;
  float* xs = W + KC * WS;
  float* hs = xs + BT * KC;
  const int t = blockIdx.x;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  const XT* xb = x + (size_t)b0 * K;
  float gate[ACC], upv[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) gate[i] = upv[i] = 0.f;
  window_matmul<XT, Vals>(xb, nb, K, gv, gp, (size_t)t * K, Sg, m, W, xs, gate);
  window_matmul<XT, Vals>(xb, nb, K, uv, up, (size_t)t * K, Su, m, W, xs, upv);
  const int l = threadIdx.x % MMAX, g = threadIdx.x / MMAX;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    // lanes past m and rows past nb hold exact zeros: padded ff lanes are
    // no-ops (silu(0) * 0 == 0)
    const float gi = gate[i];
    hs[(g + GROUPS * i) * MMAX + l] = (l < m) ? gi / (1.f + expf(-gi)) * upv[i] : 0.f;
  }
  __syncthreads();
  const int c = threadIdx.x % KC;
  for (int c0 = 0; c0 < D; c0 += KC) {
    const int cc = min(KC, D - c0);
    rebuild_rows(W, dv, dp, (size_t)t * D + c0, cc, Sd, m);
    __syncthreads();
    if (c < cc) {
      float acc[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
      for (int j = 0; j < m; ++j) {
        const float w = W[c * WS + j];
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[i] = fmaf(hs[(g + GROUPS * i) * MMAX + j], w, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int b = g + GROUPS * i;
        if (b < nb) partial[((size_t)t * B + b0 + b) * D + c0 + c] = acc[i];
      }
    }
    __syncthreads();
  }
}

// out[i] = sum over windows t = 0..T-1 of partial[t, i], in that order.
__global__ void sum_windows_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                   int T, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += partial[(size_t)t * n + i];
    out[i] = s;
  }
}

// ---------------------------------------------------------------------------
// B1/B3: the row-packed matmul (see the header).
// ---------------------------------------------------------------------------
namespace rowpk {

constexpr int RNT = 512;  // threads per block
constexpr int ROWS = 64;  // packed rows per slice: the plan's slice size
constexpr int RKC = 32;   // packed rows per chunk
constexpr int NS = 2;     // shared-memory stages: one per chunk of a slice
constexpr int UNROLL = 3; // slots a thread rebuilds at once
constexpr int PARTS = RNT / MMAX;  // threads per lane, each over a part of a chunk's rows
constexpr int PART_ROWS = RKC / PARTS;
constexpr size_t SMEM_LIMIT = 232448;  // a block's dynamic shared memory on sm_90
// W (two tiles and their rows' flags), the x tile, the slice's scales and
// the epilogue's parts
constexpr size_t SMEM_FIXED =
    (size_t)(2 * RKC * MMAX + 2 * RKC + BT * ROWS + ROWS + (PARTS - 1) * BT * MMAX) *
    sizeof(float);

static_assert(RNT == PARTS * MMAX && RKC % PARTS == 0, "PARTS threads per lane");
static_assert(ROWS == NS * RKC, "a slice's chunks are in flight together");
static_assert(PART_ROWS % 4 == 0 && (RKC * MMAX) % (4 * RNT) == 0 && RKC <= RNT,
              "16-byte x reads and zeroing");

// What the host passes besides the operands.
struct Problem {
  int B, K, T, S, m;
  int slices;        // ordered reduction slices of ROWS rows (the plan)
  int rbv;           // value bytes per packed row: S * {4, 2, 1}, S / 2 for int4
  int vvec, pvec;    // copy widths of the value and position streams: 16, 8, 4 or 1
  int sv, stage;     // bytes of a stage's values; of a whole stage (16-byte multiples)
  float* part;       // (slices, B, T*m) fp32 partials, used when slices > 1
};

// Copy n bytes from src to dst (shared) with every thread of the block, in
// pieces of vec bytes (cp.async; the last piece may be partial and reads
// only its valid bytes), or byte by byte with plain loads where vec is 1.
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const unsigned char* src, int n,
                                           int vec) {
  const int tid = threadIdx.x;
  if (vec == 16) {
    for (int i = 16 * tid; i < n; i += 16 * RNT)
      ptx::cp_async16(dst + i, src + i, min(16, n - i));
  } else if (vec == 8) {
    for (int i = 8 * tid; i < n; i += 8 * RNT) ptx::cp_async8(dst + i, src + i, min(8, n - i));
  } else if (vec == 4) {
    for (int i = 4 * tid; i < n; i += 4 * RNT) ptx::cp_async4(dst + i, src + i, min(4, n - i));
  } else {
    for (int i = tid; i < n; i += RNT) dst[i] = __ldg(src + i);
  }
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
  } else {  // int4: as Int4Values
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
  } else {  // int4: bytes i/2 and i/2 + 1, low nibble first, as Int4Values
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

// acc[b] += x[b, k] * w[k] over rows k = 0..PART_ROWS-1 (all, or those below
// ke), k ascending, for batch rows B0..B0+NB-1; the x rows (stride ROWS in
// shared memory) are read into registers first, so the loads overlap.
template <int B0, int NB, bool ALL>
__device__ __forceinline__ void multiply_rows(const float* xc, const float (&w)[PART_ROWS],
                                              int ke, float (&acc)[BT]) {
  float4 xv[NB][PART_ROWS / 4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int k4 = 0; k4 < PART_ROWS / 4; ++k4)
      xv[b][k4] = reinterpret_cast<const float4*>(xc + (B0 + b) * ROWS)[k4];
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
__device__ __forceinline__ void multiply(int nb, const float* xc, const float (&w)[PART_ROWS],
                                         int ke, float (&acc)[BT]) {
  static_assert(BT == 8, "the cases below");
  switch (nb) {
    case 1: multiply_rows<0, 1, ALL>(xc, w, ke, acc); break;
    case 2: multiply_rows<0, 2, ALL>(xc, w, ke, acc); break;
    case 3: multiply_rows<0, 3, ALL>(xc, w, ke, acc); break;
    case 4: multiply_rows<0, 4, ALL>(xc, w, ke, acc); break;
    default:
      multiply_rows<0, 4, ALL>(xc, w, ke, acc);
      switch (nb) {
        case 5: multiply_rows<4, 1, ALL>(xc, w, ke, acc); break;
        case 6: multiply_rows<4, 2, ALL>(xc, w, ke, acc); break;
        case 7: multiply_rows<4, 3, ALL>(xc, w, ke, acc); break;
        default: multiply_rows<4, 4, ALL>(xc, w, ke, acc); break;
      }
  }
}

// One block per (window t, slice z, tile of <= BT batch rows); at most 64
// registers a thread, so two blocks share an SM.
template <typename XT, int VK>
__global__ void __launch_bounds__(RNT, 2)
    row_packed_kernel(const XT* __restrict__ x, const unsigned char* __restrict__ vals,
                      const float* __restrict__ scales, const int8_t* __restrict__ pos,
                      float* __restrict__ out, const Problem pb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int t = blockIdx.x, z = blockIdx.y, b0 = blockIdx.z * BT;
  const int nb = min(BT, pb.B - b0);
  const int k0 = z * ROWS;
  const int rows = max(0, min(ROWS, pb.K - k0));  // packed rows of this slice
  const int nch = (rows + RKC - 1) / RKC;
  const float inv_s = 1.f / pb.S;  // (i + 0.5) * inv_s rounds down to i / S for i < RKC * S
  const size_t row0 = (size_t)t * pb.K + k0;  // flattened pack row of the slice's first row

  unsigned char* stages = smem_raw;  // NS (values, positions) stages
  float* W = reinterpret_cast<float*>(smem_raw + NS * pb.stage);  // two (RKC, MMAX) tiles
  float* xs = W + 2 * RKC * MMAX;                                  // (BT, ROWS)
  float* scl = xs + BT * ROWS;                                     // (ROWS)
  float* red = scl + ROWS;                                         // (PARTS - 1, BT, MMAX)
  int* flags = reinterpret_cast<int*>(red + (PARTS - 1) * BT * MMAX);  // two (RKC)

  auto issue = [&](int c) {
    if (c < nch) {
      const int kc = min(RKC, rows - c * RKC);
      const size_t r = row0 + (size_t)c * RKC;
      unsigned char* st = stages + c * pb.stage;
      copy_chunk(st, vals + r * pb.rbv, kc * pb.rbv, pb.vvec);
      copy_chunk(st + pb.sv, reinterpret_cast<const unsigned char*>(pos) + r * pb.S, kc * pb.S,
                 pb.pvec);
    }
    ptx::cp_async_commit();
  };
  auto zero_tile = [&](int buf) {  // a W tile and its rows' flags
    float4* w4 = reinterpret_cast<float4*>(W + buf * RKC * MMAX);
#pragma unroll
    for (int i = 0; i < RKC * MMAX / 4 / RNT; ++i)
      w4[tid + i * RNT] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid < RKC) flags[buf * RKC + tid] = 0;
  };

  // prologue: the slice's chunks in flight, one commit group each; the x
  // tile and the scales by plain loads meanwhile
#pragma unroll
  for (int c = 0; c < NS; ++c) issue(c);
  for (int i = tid; i < BT * ROWS; i += RNT) {
    const int b = i / ROWS, kk = i % ROWS;
    xs[i] = (b < nb && kk < rows) ? to_f32(x[(size_t)(b0 + b) * pb.K + k0 + kk]) : 0.f;
  }
  if constexpr (VK >= kInt8) {
    for (int i = tid; i < rows; i += RNT) scl[i] = scales[row0 + i];
  }
  zero_tile(0);

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
    if (c + 1 < nch) zero_tile((c + 1) & 1);

    const int kc = min(RKC, rows - c * RKC);
    const unsigned char* st = stages + c * pb.stage;
    const int8_t* ps = reinterpret_cast<const int8_t*>(st + pb.sv);
    float* Wc = W + (c & 1) * RKC * MMAX;
    // rebuild, one thread per slot (per four slots of a row where S is a
    // multiple of 4): slot i of the chunk is slot i % S of row i / S, and
    // its position byte and value lie at i.  Each occupied
    // slot stores 0 + v into its lane.  That is the sequential `W[q] += v`
    // over the row's slots in order, bitwise, when the occupied slots come
    // first with ascending lanes, as the packer writes them; a slot that
    // finds otherwise flags its row, and one thread then rebuilds each
    // flagged row in slot order (a repeated lane sums).
    int* fl = flags + (c & 1) * RKC;
    const float* sc = scl + c * RKC;
    const int n = kc * pb.S;
    int redo = 0;
    if (pb.S % 4 == 0) {
      // four slots of one row per thread: one 4-byte read of positions,
      // one read of four values
      for (int i = 4 * tid; i < n; i += 4 * RNT) {
        const int r = static_cast<int>((i + 0.5f) * inv_s), s = i - r * pb.S;
        const uint32_t qs = *reinterpret_cast<const uint32_t*>(ps + i);
        float v[4];
        quad_values<VK>(st, i, sc[r], v);
        int prev = s > 0 ? ps[i - 1] : 0;
        bool bad = false;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = static_cast<int8_t>(qs >> (8 * u));
          if (q >= 0 && q < pb.m) {
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
          v[u] = slot_value<VK>(st, r[u], i - r[u] * pb.S, pb.S, sc[r[u]]);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int i = i0 + u * RNT, s = i - r[u] * pb.S;
          if (i < n && q[u] >= 0 && q[u] < pb.m) {
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
        for (int s = 0; s < pb.S; ++s) {
          const int q = ps[tid * pb.S + s];
          if (q >= 0 && q < pb.m) Wr[q] += slot_value<VK>(st, tid, s, pb.S, sc[tid]);
        }
      }
      __syncthreads();
    }

    // multiply: this thread's part of the chunk's rows, ascending
    if (l < pb.m) {
      const float* xc = xs + c * RKC + h * PART_ROWS;
      const float* wc = Wc + h * PART_ROWS * MMAX + l;
      const int ke = kc - h * PART_ROWS;
      float w[PART_ROWS];
#pragma unroll
      for (int kk = 0; kk < PART_ROWS; ++kk) w[kk] = wc[kk * MMAX];
      if (ke >= PART_ROWS)
        multiply<true>(nb, xc, w, ke, acc);
      else
        multiply<false>(nb, xc, w, ke, acc);
    }
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

// out[i] = part[0][i] + part[1][i] + ... + part[slices-1][i], in that
// order, for n4 groups of four consecutive i (16-byte loads and stores)
// or, where V is 1, for n4 single i.  Launched as a programmatic dependent
// of row_packed_kernel: its launch overlaps that kernel's tail, and it
// waits for the partials before it reads them.
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
    for (int z = 1; z < slices; ++z) {
      const Vec v = p[(size_t)z * n4 + i];
      if constexpr (V == 4) {
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      } else {
        s += v;
      }
    }
    o[i] = s;
  }
}

// The widest copy (16, 8 or 4 bytes; else 1, plain loads) that every
// chunk start p + t * t_stride + c * c_stride is aligned to.
int copy_width(const void* p, size_t t_stride, size_t c_stride) {
  size_t a = reinterpret_cast<uintptr_t>(p) | t_stride | c_stride | 16;
  a &= ~a + 1;  // the lowest set bit
  return a >= 4 ? static_cast<int>(a) : 1;
}

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

template <typename XT, int VK>
cudaError_t launch(const void* x, const void* values, const void* scales, const void* positions,
                   void* out, Problem pb, cudaStream_t stream) {
  pb.rbv = VK == kF32 ? 4 * pb.S : VK == kBF16 ? 2 * pb.S : VK == kInt8 ? pb.S : pb.S / 2;
  const size_t t_v = pb.T > 1 ? (size_t)pb.K * pb.rbv : 0;  // window strides, where used
  const size_t t_p = pb.T > 1 ? (size_t)pb.K * pb.S : 0;
  pb.vvec = copy_width(values, t_v, (size_t)RKC * pb.rbv);
  pb.pvec = copy_width(positions, t_p, (size_t)RKC * pb.S);
  const size_t sv = align16((size_t)RKC * pb.rbv), stage = sv + align16((size_t)RKC * pb.S);
  const size_t smem = NS * stage + SMEM_FIXED;
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  pb.sv = static_cast<int>(sv);
  pb.stage = static_cast<int>(stage);

  auto kern = row_packed_kernel<XT, VK>;
  // the most any S may need, once per instantiation and device (bit d for
  // device d; two first calls racing both set the same attribute)
  static std::atomic<unsigned long long> opted_in{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(opted_in.load() & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    opted_in.fetch_or(bit);
  }
  const dim3 grid(pb.T, pb.slices, (pb.B + BT - 1) / BT);
  kern<<<grid, RNT, smem, stream>>>(static_cast<const XT*>(x),
                                   static_cast<const unsigned char*>(values),
                                   static_cast<const float*>(scales),
                                   static_cast<const int8_t*>(positions),
                                   static_cast<float*>(out), pb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ++cuda_launches[kPackedEntry];
  if (pb.slices == 1) return cudaSuccess;

  const size_t n = (size_t)pb.B * pb.T * pb.m;
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(out) |
                                  reinterpret_cast<uintptr_t>(pb.part)) % 16 == 0;
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
  e = cudaLaunchKernelEx(&cfg, vec ? sum_slices_kernel<4> : sum_slices_kernel<1>,
                         static_cast<const float*>(pb.part), static_cast<float*>(out), n4,
                         pb.slices);
  if (e == cudaSuccess) ++cuda_launches[kPackedEntry];
  return e;
}

template <typename XT>
cudaError_t for_x(const void* x, const void* values, int kind, const void* scales,
                  const void* positions, void* out, const Problem& pb, cudaStream_t st) {
  switch (kind) {
    case kF32: return launch<XT, kF32>(x, values, scales, positions, out, pb, st);
    case kBF16: return launch<XT, kBF16>(x, values, scales, positions, out, pb, st);
    case kInt8: return launch<XT, kInt8>(x, values, scales, positions, out, pb, st);
    case kInt4: return launch<XT, kInt4>(x, values, scales, positions, out, pb, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace rowpk

__global__ void empty_kernel() {}

template <typename XT, typename Vals>
cudaError_t launch_fused(const void* x, const void* gv, const void* gs, const void* gp, int Sg,
                         const void* uv, const void* us, const void* up, int Su, const void* dv,
                         const void* ds, const void* dp, int Sd, void* partial, void* out, int B,
                         int K, int D, int T, int m, cudaStream_t stream) {
  auto kern = fused_mlp_partial_kernel<XT, Vals>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_FUSED);
  if (e != cudaSuccess) return e;
  const dim3 grid(T, (B + BT - 1) / BT);
  kern<<<grid, NT, SMEM_FUSED, stream>>>(
      static_cast<const XT*>(x), Vals::make(gv, gs, Sg), static_cast<const int8_t*>(gp), Sg,
      Vals::make(uv, us, Su), static_cast<const int8_t*>(up), Su, Vals::make(dv, ds, Sd),
      static_cast<const int8_t*>(dp), Sd, static_cast<float*>(partial), B, K, D, m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ++cuda_launches[kFusedEntry];
  const int n = B * D;
  sum_windows_kernel<<<(n + NT - 1) / NT, NT, 0, stream>>>(static_cast<const float*>(partial),
                                                           static_cast<float*>(out), T, n);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++cuda_launches[kFusedEntry];
  return e;
}

template <typename XT>
cudaError_t fused_for_x(const void* x, int kind, const void* gv, const void* gs, const void* gp,
                        int Sg, const void* uv, const void* us, const void* up, int Su,
                        const void* dv, const void* ds, const void* dp, int Sd, void* partial,
                        void* out, int B, int K, int D, int T, int m, cudaStream_t st) {
  switch (kind) {
    case kF32:
      return launch_fused<XT, FloatValues<float>>(x, gv, gs, gp, Sg, uv, us, up, Su, dv, ds, dp,
                                                  Sd, partial, out, B, K, D, T, m, st);
    case kBF16:
      return launch_fused<XT, FloatValues<__nv_bfloat16>>(x, gv, gs, gp, Sg, uv, us, up, Su, dv,
                                                          ds, dp, Sd, partial, out, B, K, D, T, m,
                                                          st);
    case kInt8:
      return launch_fused<XT, Int8Values>(x, gv, gs, gp, Sg, uv, us, up, Su, dv, ds, dp, Sd,
                                          partial, out, B, K, D, T, m, st);
    case kInt4:
      return launch_fused<XT, Int4Values>(x, gv, gs, gp, Sg, uv, us, up, Su, dv, ds, dp, Sd,
                                          partial, out, B, K, D, T, m, st);
  }
  return cudaErrorInvalidValue;
}

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
  const rowpk::Problem pb{B, K, T, S, m, slices, 0, 0, 0, 0, 0, static_cast<float*>(part)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return rowpk::for_x<__nv_bfloat16>(x, values, value_kind, scales, positions, out, pb, st);
  return rowpk::for_x<float>(x, values, value_kind, scales, positions, out, pb, st);
}

// x (B, K); gate/up (T, K, Sg/Su) packs with scales (T, K); down_t (T, D, Sd)
// with scales (T, D); all values of one value_kind (as above; scales
// ignored for float kinds); partial (T, B, D) fp32 scratch; out (B, D) fp32.
int vusa_fused_mlp_matmul(const void* x, int x_bf16, int value_kind, const void* gv,
                          const void* gs, const void* gp, int Sg, const void* uv, const void* us,
                          const void* up, int Su, const void* dv, const void* ds, const void* dp,
                          int Sd, void* partial, void* out, int B, int K, int D, int T, int m,
                          void* stream) {
  if (m < 1 || m > MMAX || B < 0 || K < 0 || D < 0 || T < 0) return cudaErrorInvalidValue;
  if (bad_values(value_kind, gs, Sg) || bad_values(value_kind, us, Su) ||
      bad_values(value_kind, ds, Sd))
    return cudaErrorInvalidValue;
  if (B == 0 || D == 0) return cudaSuccess;
  if (T == 0) return cudaMemsetAsync(out, 0, (size_t)B * D * sizeof(float),
                                     static_cast<cudaStream_t>(stream));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return fused_for_x<__nv_bfloat16>(x, value_kind, gv, gs, gp, Sg, uv, us, up, Su, dv, ds, dp,
                                      Sd, partial, out, B, K, D, T, m, st);
  return fused_for_x<float>(x, value_kind, gv, gs, gp, Sg, uv, us, up, Su, dv, ds, dp, Sd,
                            partial, out, B, K, D, T, m, st);
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
