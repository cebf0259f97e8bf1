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
// The quantized kernels are the dense ones with another value loader (below):
// each slot's value is rebuilt as q * scale[window, row] where the slot is
// read, so only the quantized bytes ever come from device memory.
//
// What bounds them on this card: bytes.  At decode batch sizes (B <= 8) each
// packed slot (a value plus an int8 lane position) is read once and used for
// B multiply-adds, far below the ~20 fp32 operations per byte the H100 needs
// before its fp32 rate, let alone its tensor cores, becomes the limit.  The
// least time is the pack's bytes over 3.35 TB/s: every position, the value
// bytes of the occupied slots (4 or 2 for float values, 1 for int8, 1/2 for
// int4) and, for quantized packs, one fp32 scale per (window, row).
//
// What the design does about it: every slot is read from device memory
// exactly once per batch tile (one block per output window, all B <= 8 rows
// of the tile sharing the reconstructed tile in shared memory), and nothing
// dense is ever written back: the (K, m) weight tile is rebuilt in shared
// memory chunk by chunk, and in the fused MLP the (B, ff) hidden state lives
// only in shared memory.  This first version keeps the arithmetic simple and
// deterministic; it does not yet overlap loads with compute (no TMA or
// cp.async ring), and the fused MLP needs a second launch for its ordered
// cross-window sum.
//
// Determinism contracts (the speculative-decoding slice relies on them):
//   * row b of an output never depends on B: each output element accumulates
//     over k (or over the window's lanes) in one fixed order, with fmaf,
//     whatever the batch tile holds;
//   * no split-K and no float atomics: the fused MLP writes per-window
//     partials and sums them over windows in order 0..T-1 in a second kernel;
//   * a dequantized value is exactly the fp32 product q * scale (__fmul_rn:
//     never contracted into an fma with the add that follows), as the plain
//     version and the host-side dequant compute it.
//
// Semantics kept from the reference's one-hot reconstruction: a row's slots
// add into their lanes in slot order (a repeated lane sums), idle slots
// (position -1) and positions outside [0, m) contribute nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// One block per (output window t, tile of <= BT batch rows).
template <typename XT, typename Vals>
__global__ void __launch_bounds__(NT)
vusa_packed_kernel(const XT* __restrict__ x, const Vals vals, const int8_t* __restrict__ pos,
                   float* __restrict__ out, int B, int K, int T, int S, int m) {
  extern __shared__ float smem[];
  float* W = smem;
  float* xs = smem + KC * WS;
  const int t = blockIdx.x;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  window_matmul<XT, Vals>(x + (size_t)b0 * K, nb, K, vals, pos, (size_t)t * K, S, m, W, xs,
                          acc);
  const int l = threadIdx.x % MMAX, g = threadIdx.x / MMAX;
  if (l < m) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int b = g + GROUPS * i;
      if (b < nb) out[(size_t)(b0 + b) * T * m + (size_t)t * m + l] = acc[i];
    }
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

template <typename XT, typename Vals>
cudaError_t launch_packed(const void* x, const Vals vals, const void* pos, void* out, int B,
                          int K, int T, int S, int m, cudaStream_t stream) {
  auto kern = vusa_packed_kernel<XT, Vals>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MATMUL);
  if (e != cudaSuccess) return e;
  const dim3 grid(T, (B + BT - 1) / BT);
  kern<<<grid, NT, SMEM_MATMUL, stream>>>(static_cast<const XT*>(x), vals,
                                          static_cast<const int8_t*>(pos),
                                          static_cast<float*>(out), B, K, T, S, m);
  return cudaGetLastError();
}

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
  const int n = B * D;
  sum_windows_kernel<<<(n + NT - 1) / NT, NT, 0, stream>>>(static_cast<const float*>(partial),
                                                           static_cast<float*>(out), T, n);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t packed_for_x(const void* x, const void* values, int kind, const void* scales,
                         const void* pos, void* out, int B, int K, int T, int S, int m,
                         cudaStream_t st) {
  switch (kind) {
    case kF32:
      return launch_packed<XT>(x, FloatValues<float>::make(values, scales, S), pos, out, B, K, T,
                               S, m, st);
    case kBF16:
      return launch_packed<XT>(x, FloatValues<__nv_bfloat16>::make(values, scales, S), pos, out,
                               B, K, T, S, m, st);
    case kInt8:
      return launch_packed<XT>(x, Int8Values::make(values, scales, S), pos, out, B, K, T, S, m,
                               st);
    case kInt4:
      return launch_packed<XT>(x, Int4Values::make(values, scales, S), pos, out, B, K, T, S, m,
                               st);
  }
  return cudaErrorInvalidValue;
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
// (B, T*m) fp32.  Returns a cudaError_t (0 = launched).
int vusa_packed_matmul(const void* x, int x_bf16, const void* values, int value_kind,
                       const void* scales, const void* positions, void* out, int B, int K, int T,
                       int S, int m, void* stream) {
  if (m < 1 || m > MMAX || B < 0 || K < 0 || T < 0 || S < 0) return cudaErrorInvalidValue;
  if (bad_values(value_kind, scales, S)) return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return packed_for_x<__nv_bfloat16>(x, values, value_kind, scales, positions, out, B, K, T, S,
                                       m, st);
  return packed_for_x<float>(x, values, value_kind, scales, positions, out, B, K, T, S, m, st);
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

const char* vusa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
