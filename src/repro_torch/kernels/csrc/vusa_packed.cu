// VUSA row-packed matmul kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the two dense-value Pallas TPU kernels of the JAX package:
//   * vusa_packed_matmul    <- repro/kernels/vusa_packed.py `_kernel`
//     (+ `_reconstruct_onehot` / `_reconstruct_loop`), called from
//     `vusa_packed_matmul`;
//   * vusa_fused_mlp_matmul <- repro/kernels/vusa_packed.py `_fused_mlp_kernel`
//     (+ `_matmul_packed_window`), called from `vusa_fused_mlp_matmul`.
//
// What bounds them on this card: bytes.  At decode batch sizes (B <= 8) each
// packed slot (a value plus an int8 lane position) is read once and used for
// B multiply-adds, far below the ~20 fp32 operations per byte the H100 needs
// before its fp32 rate, let alone its tensor cores, becomes the limit.  The
// least time is the pack's bytes over 3.35 TB/s.
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
//     partials and sums them over windows in order 0..T-1 in a second kernel.
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

// Rebuild rows [r0, r0 + rows) of one window's pack into W (rows x m, stride
// WS).  Thread r owns row r: it zeroes the row, then adds the row's slots
// into their lanes in slot order.  No two threads touch one row, so no
// atomics are needed and a repeated lane sums in a fixed order.
template <typename VT>
__device__ __forceinline__ void rebuild_rows(float* W, const VT* __restrict__ vals,
                                             const int8_t* __restrict__ pos, int r0, int rows,
                                             int S, int m) {
  const int r = threadIdx.x;
  if (r < rows) {
    float* row = W + r * WS;
    for (int j = 0; j < m; ++j) row[j] = 0.f;
    const VT* v = vals + (size_t)(r0 + r) * S;
    const int8_t* p = pos + (size_t)(r0 + r) * S;
    for (int s = 0; s < S; ++s) {
      const int q = p[s];
      if (q >= 0 && q < m) row[q] += to_f32(v[s]);
    }
  }
}

// acc[i] += sum_k x[b, k] * W_window[k, l] for this thread's outputs
// (b = g + GROUPS * i, l), k ascending.  x points at the tile's first row
// (nb rows of length K); vals/pos at the window's (K, S) pack.
template <typename XT, typename VT>
__device__ void window_matmul(const XT* __restrict__ x, int nb, int K,
                              const VT* __restrict__ vals, const int8_t* __restrict__ pos,
                              int S, int m, float* W, float* xs, float (&acc)[ACC]) {
  const int tid = threadIdx.x;
  const int l = tid % MMAX, g = tid / MMAX;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    for (int i = tid; i < BT * KC; i += NT) {
      const int b = i / KC, kk = i % KC;
      xs[i] = (b < nb && kk < kc) ? to_f32(x[(size_t)b * K + k0 + kk]) : 0.f;
    }
    rebuild_rows(W, vals, pos, k0, kc, S, m);
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
template <typename XT, typename VT>
__global__ void __launch_bounds__(NT)
vusa_packed_kernel(const XT* __restrict__ x, const VT* __restrict__ vals,
                   const int8_t* __restrict__ pos, float* __restrict__ out, int B, int K, int T,
                   int S, int m) {
  extern __shared__ float smem[];
  float* W = smem;
  float* xs = smem + KC * WS;
  const int t = blockIdx.x;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  window_matmul<XT, VT>(x + (size_t)b0 * K, nb, K, vals + (size_t)t * K * S,
                        pos + (size_t)t * K * S, S, m, W, xs, acc);
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
template <typename XT, typename VT>
__global__ void __launch_bounds__(NT)
fused_mlp_partial_kernel(const XT* __restrict__ x, const VT* __restrict__ gv,
                         const int8_t* __restrict__ gp, int Sg, const VT* __restrict__ uv,
                         const int8_t* __restrict__ up, int Su, const VT* __restrict__ dv,
                         const int8_t* __restrict__ dp, int Sd, float* __restrict__ partial,
                         int B, int K, int D, int m) {
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
  window_matmul<XT, VT>(xb, nb, K, gv + (size_t)t * K * Sg, gp + (size_t)t * K * Sg, Sg, m, W, xs,
                        gate);
  window_matmul<XT, VT>(xb, nb, K, uv + (size_t)t * K * Su, up + (size_t)t * K * Su, Su, m, W, xs,
                        upv);
  const int l = threadIdx.x % MMAX, g = threadIdx.x / MMAX;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    // lanes past m and rows past nb hold exact zeros: padded ff lanes are
    // no-ops (silu(0) * 0 == 0)
    const float gi = gate[i];
    hs[(g + GROUPS * i) * MMAX + l] = (l < m) ? gi / (1.f + expf(-gi)) * upv[i] : 0.f;
  }
  __syncthreads();
  const VT* dvt = dv + (size_t)t * D * Sd;
  const int8_t* dpt = dp + (size_t)t * D * Sd;
  const int c = threadIdx.x % KC;
  for (int c0 = 0; c0 < D; c0 += KC) {
    const int cc = min(KC, D - c0);
    rebuild_rows(W, dvt, dpt, c0, cc, Sd, m);
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

template <typename XT, typename VT>
cudaError_t launch_packed(const void* x, const void* vals, const void* pos, void* out, int B,
                          int K, int T, int S, int m, cudaStream_t stream) {
  auto kern = vusa_packed_kernel<XT, VT>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MATMUL);
  if (e != cudaSuccess) return e;
  const dim3 grid(T, (B + BT - 1) / BT);
  kern<<<grid, NT, SMEM_MATMUL, stream>>>(static_cast<const XT*>(x), static_cast<const VT*>(vals),
                                          static_cast<const int8_t*>(pos),
                                          static_cast<float*>(out), B, K, T, S, m);
  return cudaGetLastError();
}

template <typename XT, typename VT>
cudaError_t launch_fused(const void* x, const void* gv, const void* gp, int Sg, const void* uv,
                         const void* up, int Su, const void* dv, const void* dp, int Sd,
                         void* partial, void* out, int B, int K, int D, int T, int m,
                         cudaStream_t stream) {
  auto kern = fused_mlp_partial_kernel<XT, VT>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_FUSED);
  if (e != cudaSuccess) return e;
  const dim3 grid(T, (B + BT - 1) / BT);
  kern<<<grid, NT, SMEM_FUSED, stream>>>(
      static_cast<const XT*>(x), static_cast<const VT*>(gv), static_cast<const int8_t*>(gp), Sg,
      static_cast<const VT*>(uv), static_cast<const int8_t*>(up), Su, static_cast<const VT*>(dv),
      static_cast<const int8_t*>(dp), Sd, static_cast<float*>(partial), B, K, D, m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = B * D;
  sum_windows_kernel<<<(n + NT - 1) / NT, NT, 0, stream>>>(static_cast<const float*>(partial),
                                                           static_cast<float*>(out), T, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, K) fp32 or bf16; values (T, K, S) fp32 or bf16; positions (T, K, S)
// int8; out (B, T*m) fp32.  Returns a cudaError_t (0 = launched).
int vusa_packed_matmul(const void* x, int x_bf16, const void* values, int v_bf16,
                       const void* positions, void* out, int B, int K, int T, int S, int m,
                       void* stream) {
  if (m < 1 || m > MMAX || B < 0 || K < 0 || T < 0 || S < 0) return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (v_bf16)
      return launch_packed<__nv_bfloat16, __nv_bfloat16>(x, values, positions, out, B, K, T, S, m,
                                                         st);
    return launch_packed<__nv_bfloat16, float>(x, values, positions, out, B, K, T, S, m, st);
  }
  if (v_bf16)
    return launch_packed<float, __nv_bfloat16>(x, values, positions, out, B, K, T, S, m, st);
  return launch_packed<float, float>(x, values, positions, out, B, K, T, S, m, st);
}

// x (B, K); gate/up (T, K, Sg/Su); down_t (T, D, Sd) with values of one
// dtype; partial (T, B, D) fp32 scratch; out (B, D) fp32.
int vusa_fused_mlp_matmul(const void* x, int x_bf16, const void* gv, const void* gp, int Sg,
                          const void* uv, const void* up, int Su, const void* dv, const void* dp,
                          int Sd, int v_bf16, void* partial, void* out, int B, int K, int D, int T,
                          int m, void* stream) {
  if (m < 1 || m > MMAX || B < 0 || K < 0 || D < 0 || T < 0) return cudaErrorInvalidValue;
  if (B == 0 || D == 0) return cudaSuccess;
  if (T == 0) return cudaMemsetAsync(out, 0, (size_t)B * D * sizeof(float),
                                     static_cast<cudaStream_t>(stream));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (v_bf16)
      return launch_fused<__nv_bfloat16, __nv_bfloat16>(x, gv, gp, Sg, uv, up, Su, dv, dp, Sd,
                                                        partial, out, B, K, D, T, m, st);
    return launch_fused<__nv_bfloat16, float>(x, gv, gp, Sg, uv, up, Su, dv, dp, Sd, partial, out,
                                              B, K, D, T, m, st);
  }
  if (v_bf16)
    return launch_fused<float, __nv_bfloat16>(x, gv, gp, Sg, uv, up, Su, dv, dp, Sd, partial, out,
                                              B, K, D, T, m, st);
  return launch_fused<float, float>(x, gv, gp, Sg, uv, up, Su, dv, dp, Sd, partial, out, B, K, D,
                                    T, m, st);
}

const char* vusa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
