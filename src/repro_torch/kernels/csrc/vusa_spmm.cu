// Block-VUSA packed matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_kernel` of repro/kernels/vusa_spmm.py,
// called from `vusa_spmm`:
//   y[b, t*Tn + n] = sum_j sum_a x[b, row_idx[t, j, a]] * values[t, j, a, n]
// x (B, K) fp32 or bf16, values (T, J, A, Tn = 128) fp32, row_idx (T, J, A)
// int32; y (B, T*Tn) in x's dtype, accumulated in fp32 and rounded once.
//
// What bounds it on this card: mostly operations.  At the paper's workloads
// B is the number of output pixels (49 .. 12,544), so every packed weight
// row is used B times, and 2*B*T*J*A*Tn fp32 operations over 67 TFLOP/s
// exceed the bytes (values, row_idx, x and y) over 3.35 TB/s on 19 of
// ResNet-18's 21 GEMMs; bytes bound the fully connected layers (B = 1),
// MobileNetV1's depthwise layers (K = 9), its first convolution and its
// first pointwise layer.
//
// What the design does about it (tile_gemm.cuh): the TPU kernel keeps all of
// x resident in VMEM and walks one output tile per grid step; at B = 12,544
// x does not fit in shared memory, so here a grid over (block of BM rows of
// B, output tile t) walks the jobs in order, gathering each stage's 4 jobs
// of A = 8 x columns through row_idx into shared memory beside their 8 x 128
// value rows (prefetched a stage ahead), and keeps the BM x 128
// accumulators in registers.  The gather is the only difference from the
// dense baseline: the 8 indices of a job are ascending rows of one 32-row
// window, so a warp's reads stay within a few 32-byte sectors of each x
// row, but each stage's x reads wait on its row_idx reads.
//
// Semantics kept from the reference: the reduction runs jobs first, then
// a within a job, one fixed order (no split-K, no atomics); padding rows
// (row_idx 0, value 0) are multiplied like any other, as jnp.dot multiplies
// them, so a non-finite x[:, 0] propagates exactly as in the Pallas kernel;
// the output is rounded from fp32 to x's dtype once, at the end.

#include "tile_gemm.cuh"

namespace {

using tile_gemm::BN;

struct SpmmOp {
  const float* values;   // (T, JA, BN)
  const int* row_idx;    // (T, JA)
  int nk;                // JA = J * A
  int ncols;             // T * BN

  __device__ __forceinline__ int x_col(int t, int k) const {
    return __ldg(row_idx + (size_t)t * nk + k);
  }
  // job rows are contiguous 512-byte rows: one 16-byte load
  __device__ __forceinline__ float4 w4(int t, int k, int c4) const {
    return __ldg(reinterpret_cast<const float4*>(values + ((size_t)t * nk + k) * BN) + c4);
  }
};

template <typename XT>
cudaError_t launch_spmm(const void* x, const void* values, const void* row_idx, void* out,
                        int B, int K, int T, int JA, cudaStream_t stream) {
  const SpmmOp op{static_cast<const float*>(values), static_cast<const int*>(row_idx), JA,
                  T * BN};
  return tile_gemm::launch(static_cast<const XT*>(x), K, static_cast<XT*>(out), T * BN, B, T, op,
                           stream);
}

}  // namespace

extern "C" {

// x (B, K) fp32 (x_bf16 = 0) or bf16 (1); values (T, J*A, 128) fp32;
// row_idx (T, J*A) int32, each in [0, K); out (B, T*128) of x's dtype.
// Returns a cudaError_t (0 = launched).
int vusa_spmm(const void* x, int x_bf16, const void* values, const void* row_idx, void* out,
              int B, int K, int T, int JA, void* stream) {
  if (B < 0 || K < 0 || T < 0 || JA < 0 || T > 65535) return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) return launch_spmm<__nv_bfloat16>(x, values, row_idx, out, B, K, T, JA, st);
  return launch_spmm<float>(x, values, row_idx, out, B, K, T, JA, st);
}

const char* vusa_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
