// Block-VUSA packed matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_kernel` of repro/kernels/vusa_spmm.py,
// called from `vusa_spmm`:
//   y[b, t*Tn + n] = sum_j sum_a x[b, row_idx[t, j, a]] * values[t, j, a, n]
// x (B, K) fp32 or bf16, values (T, J, A, Tn = 128) fp32, row_idx (T, J, A)
// int32; y (B, ncols) in x's dtype, ncols <= T*Tn (the reference returns
// all T*Tn lanes; ncols skips the padded ones), accumulated in fp32 and
// rounded once.
//
// What bounds it on this card: by the data sheet, mostly operations.  At
// the paper's workloads B is the number of output pixels (49 .. 12,544), so
// every packed weight row is used B times, and 2*B*J*A*ncols fp32
// operations over 67 TFLOP/s exceed the bytes (values, row_idx, x and y)
// over 3.35 TB/s on most GEMMs; bytes bound the fully connected layers
// (B = 1) and MobileNetV1's depthwise layers (K = 9).  In practice each
// GEMM is small (a few microseconds), and what decides its time is
// parallelism and latency: the deep layers (B = 49 .. 196) have few output
// tiles and up to 576 jobs per tile.
//
// What the design does about it (tile_gemm.cuh): the TPU kernel keeps all of
// x resident in VMEM and walks one output tile per grid step; at B = 12,544
// x does not fit in shared memory, so here a grid over (32 rows of B, 64
// lanes of an output tile, slice of the jobs) walks its run of consecutive
// jobs in stages of 4 jobs of A = 8 rows, gathering each stage's x columns
// through row_idx with 4-byte cp.async into a ring of three shared-memory
// stages beside their value rows (16-byte cp.async); the row_idx entries of
// a stage are read one iteration before its copies are issued, so the
// gather's dependent load overlaps the products.  The products run on the
// tensor cores in split-precision TF32 (3xTF32, about 2^-20 relative error
// per product).  A call whose jobs span more than 8 stages is cut into
// slices of at most 4 stages; their fp32 partials are summed in slice order
// by a second launch; the wrapper runs the rows in chunks whose partials
// fit a fixed workspace (kernels/tile_plan.py).  The gather is the only
// difference from the dense baseline: the 8 indices of a job are ascending
// rows of one 32-row window, so a warp's 32 reads of one x row fall in a
// few 32-byte sectors.
//
// Semantics kept from the reference: the reduction runs jobs first, then
// a within a job, in one fixed order for a given pack shape (slices of
// consecutive jobs summed in order; no atomics); rows do not depend on B;
// padding rows (row_idx 0, value 0) are multiplied like any other, as
// jnp.dot multiplies them, so a NaN in x[:, 0] reaches the same outputs as
// in the plain version, and so does a +-inf, with its sign (tile_gemm.cuh
// names the one exception, subnormals TF32 drops); the output is rounded
// from fp32 to x's dtype once, at the end.

#include "tile_gemm.cuh"

namespace {

constexpr int TN = 128;  // lanes of a block-VUSA output tile

struct SpmmOp {
  static constexpr bool kGather = true;
  using WT = float;
  const float* values;  // (T, JA, TN)
  const int* row_idx;   // (T, JA)
  int nk;               // JA = J * A
  bool w_vec = true;    // job rows are 512 bytes, their 64-lane halves 16-byte aligned

  __device__ __forceinline__ int x_col(int n0, int k) const {
    return __ldg(row_idx + (size_t)(n0 / TN) * nk + k);
  }
  __device__ __forceinline__ const float* w_row(int n0, int k) const {
    return values + ((size_t)(n0 / TN) * nk + k) * TN + n0 % TN;
  }
};

template <typename XT>
cudaError_t launch_spmm(const void* x, const void* values, const void* row_idx, void* out,
                        float* part, int B, int K, int JA, int ncols, int S, int bm, int bn,
                        int ks, cudaStream_t stream) {
  const SpmmOp op{static_cast<const float*>(values), static_cast<const int*>(row_idx), JA};
  const tile_gemm::Problem pb{B, K, false, JA, ncols, S, part};
  return tile_gemm::launch(static_cast<const XT*>(x), static_cast<XT*>(out), pb, bm, bn, ks,
                           op, stream);
}

}  // namespace

extern "C" {

// x (B, K) fp32 (x_bf16 = 0) or bf16 (1); values (T, J*A, 128) fp32;
// row_idx (T, J*A) int32, each in [0, K); out (B, ncols) of x's dtype,
// 0 < ncols <= T*128.  The plan (S, bm, bn, ks) comes from the host
// (kernels/tile_plan.py); part holds S*B*ncols fp32 when S > 1.  Returns a
// cudaError_t (0 = launched).
int vusa_spmm(const void* x, int x_bf16, const void* values, const void* row_idx, void* out,
              void* part, int B, int K, int T, int JA, int ncols, int S, int bm, int bn, int ks,
              void* stream) {
  if (B < 0 || K < 0 || T < 0 || JA < 0 || ncols < 0 || (long)ncols > (long)T * TN)
    return cudaErrorInvalidValue;
  if (B == 0 || ncols == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (x_bf16)
    return launch_spmm<__nv_bfloat16>(x, values, row_idx, out, p, B, K, JA, ncols, S, bm, bn,
                                      ks, st);
  return launch_spmm<float>(x, values, row_idx, out, p, B, K, JA, ncols, S, bm, bn, ks, st);
}

// CUDA launches this library has issued since it was loaded.
unsigned long long vusa_spmm_cuda_launches() { return tile_gemm::cuda_launches.load(); }

const char* vusa_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
