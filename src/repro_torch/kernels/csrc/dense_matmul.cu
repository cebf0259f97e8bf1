// Dense tiled matmul for Hopper (sm_90a), plain C interface: the paper's
// "standard weight-stationary systolic array" baseline.
//
// Replaces the Pallas TPU kernel `_kernel` of repro/kernels/dense_matmul.py,
// called from `dense_matmul`: y = x @ w, x (M, K), w (K, N), each fp32 or
// bf16 (widened to fp32 exactly on load), y (M, N) fp32, accumulated in
// fp32 over K in one fixed order.
//
// What bounds it on this card: mostly operations at the paper's workloads
// (M, the output pixels, reuses every weight M times; 2*M*N*K fp32
// operations over 67 TFLOP/s against (M*K + K*N + M*N) * 4 bytes over
// 3.35 TB/s), bytes where M is 1 (the fully connected layers) or K is tiny
// (MobileNetV1's depthwise layers, K = 9).
//
// What the design does about it: a shared-memory tiled SGEMM with register
// blocking and a stage of prefetch (tile_gemm.cuh), the same skeleton and
// the same 16-byte weight loads as the block-VUSA kernel (vusa_spmm.cu),
// with x's columns read in order instead of gathered.  The
// TPU kernel carries its output block across a sequential K grid axis;
// here one block owns a BM x 128 output tile and walks K itself, so no
// partial sum leaves the block (no split-K, no atomics).  The kernel
// checks its own edges (rows, columns and K need not be multiples of the
// tile); the wrapper keeps the reference's shape contract.

#include "tile_gemm.cuh"

namespace {

using tile_gemm::BN;

__device__ __forceinline__ float4 widen4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {  // bf16 -> fp32 is exact
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
}

template <typename WT>
struct DenseOp {
  const WT* w;  // (K, N)
  int nk;       // K
  int ncols;    // N
  bool vec;     // rows start 16-byte (fp32) / 8-byte (bf16) aligned: N % 4 == 0

  __device__ __forceinline__ int x_col(int, int k) const { return k; }
  // columns t*BN + 4*c4 .. +3 of row k: one vector load inside the matrix,
  // element by element (0 past N) at a ragged edge
  __device__ __forceinline__ float4 w4(int t, int k, int c4) const {
    const int n = t * BN + 4 * c4;
    const WT* p = w + (size_t)k * ncols + n;
    if (vec && n + 3 < ncols) return widen4(p);
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = n + c < ncols ? tile_gemm::to_f32(p[c]) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <typename XT, typename WT>
cudaError_t launch_dense(const void* x, const void* w, void* out, int M, int K, int N,
                         cudaStream_t stream) {
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % (4 * sizeof(WT)) == 0;
  const DenseOp<WT> op{static_cast<const WT*>(w), K, N, vec};
  return tile_gemm::launch(static_cast<const XT*>(x), K, static_cast<float*>(out), N, M,
                           (N + BN - 1) / BN, op, stream);
}

}  // namespace

extern "C" {

// x (M, K) fp32 (x_bf16 = 0) or bf16 (1); w (K, N) fp32 or bf16 (w_bf16);
// out (M, N) fp32.  Returns a cudaError_t (0 = launched).
int dense_matmul(const void* x, int x_bf16, const void* w, int w_bf16, void* out, int M, int K,
                 int N, void* stream) {
  if (M < 0 || K < 0 || N < 0 || (N + BN - 1) / BN > 65535) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (w_bf16) return launch_dense<__nv_bfloat16, __nv_bfloat16>(x, w, out, M, K, N, st);
    return launch_dense<__nv_bfloat16, float>(x, w, out, M, K, N, st);
  }
  if (w_bf16) return launch_dense<float, __nv_bfloat16>(x, w, out, M, K, N, st);
  return launch_dense<float, float>(x, w, out, M, K, N, st);
}

const char* dense_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
