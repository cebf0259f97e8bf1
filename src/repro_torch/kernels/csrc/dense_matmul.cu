// Dense tiled matmul for Hopper (sm_90a), plain C interface: the paper's
// "standard weight-stationary systolic array" baseline.
//
// Replaces the Pallas TPU kernel `_kernel` of repro/kernels/dense_matmul.py,
// called from `dense_matmul`: y = x @ w, x (M, K), w (K, N), each fp32 or
// bf16 (widened to fp32 exactly on load), y (M, N) fp32, accumulated in
// fp32 over K in one fixed order.
//
// What bounds it on this card: by the data sheet, mostly operations at the
// paper's workloads (M, the output pixels, reuses every weight M times;
// 2*M*N*K fp32 operations over 67 TFLOP/s against (M*K + K*N + M*N) * 4
// bytes over 3.35 TB/s), bytes where M is 1 (the fully connected layers)
// or K is tiny (MobileNetV1's depthwise layers, K = 9).  In practice each
// GEMM lasts a few microseconds and parallelism and latency decide it, most
// of all on the deep layers, whose few output tiles each reduce up to
// K = 4608.
//
// What the design does about it: the skeleton of tile_gemm.cuh, the same as
// the block-VUSA kernel's (vusa_spmm.cu), with x's columns read in order
// instead of gathered: 32 x 64 output tiles, 16-byte cp.async of x rows and
// weight rows into a three-stage shared-memory ring, split-precision TF32
// tensor-core products (3xTF32), and, for K above 256, an ordered split of
// K into slices of at most 128 rows whose fp32 partials a second launch
// sums in slice order (the TPU kernel carries its output block across a
// sequential K grid axis; here the K ranges run in parallel and meet in one
// fixed order, no atomics; the wrapper runs the rows in chunks whose
// partials fit a fixed workspace, kernels/tile_plan.py).  Rows with a
// ragged K (K % 4 != 0) or a ragged N take 4-byte copies, and bf16
// operands plain loads.  The kernel checks
// its own edges (rows, columns and K need not be multiples of the tile);
// the wrapper keeps the reference's shape contract.

#include "tile_gemm.cuh"

namespace {

template <typename W>
struct DenseOp {
  static constexpr bool kGather = false;
  using WT = W;
  const W* w;  // (K, N)
  int ldw;     // N
  bool w_vec;  // fp32 rows 16-byte aligned: N % 4 == 0 and w aligned

  __device__ __forceinline__ int x_col(int, int k) const { return k; }
  __device__ __forceinline__ const W* w_row(int n0, int k) const {
    return w + (size_t)k * ldw + n0;
  }
};

template <typename XT, typename WT>
cudaError_t launch_dense(const void* x, const void* w, void* out, float* part, int M,
                         int K, int N, int S, int bm, int bn, int ks, cudaStream_t stream) {
  const bool x_vec = std::is_same<XT, float>::value && K % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool w_vec = std::is_same<WT, float>::value && N % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const DenseOp<WT> op{static_cast<const WT*>(w), N, w_vec};
  const tile_gemm::Problem pb{M, K, x_vec, K, N, S, part};
  return tile_gemm::launch(static_cast<const XT*>(x), static_cast<float*>(out), pb, bm, bn, ks,
                           op, stream);
}

}  // namespace

extern "C" {

// x (M, K) fp32 (x_bf16 = 0) or bf16 (1); w (K, N) fp32 or bf16 (w_bf16);
// out (M, N) fp32.  The plan (S, bm, bn, ks) comes from the host
// (kernels/tile_plan.py); part holds S*M*N fp32 when S > 1.  Returns a
// cudaError_t (0 = launched).
int dense_matmul(const void* x, int x_bf16, const void* w, int w_bf16, void* out, void* part,
                 int M, int K, int N, int S, int bm, int bn, int ks, void* stream) {
  if (M < 0 || K < 0 || N < 0) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (x_bf16) {
    if (w_bf16)
      return launch_dense<__nv_bfloat16, __nv_bfloat16>(x, w, out, p, M, K, N, S, bm, bn, ks,
                                                        st);
    return launch_dense<__nv_bfloat16, float>(x, w, out, p, M, K, N, S, bm, bn, ks, st);
  }
  if (w_bf16)
    return launch_dense<float, __nv_bfloat16>(x, w, out, p, M, K, N, S, bm, bn, ks, st);
  return launch_dense<float, float>(x, w, out, p, M, K, N, S, bm, bn, ks, st);
}

// CUDA launches this library has issued since it was loaded.
unsigned long long dense_matmul_cuda_launches() { return tile_gemm::cuda_launches.load(); }

const char* dense_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
