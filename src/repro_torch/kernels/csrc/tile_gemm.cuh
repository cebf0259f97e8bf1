// Shared-memory tiled fp32 GEMM skeleton for Hopper (sm_90a), shared by the
// block-VUSA product (vusa_spmm.cu) and the dense baseline (dense_matmul.cu).
//
// Both kernels compute out[r, t*BN + n] = sum_k x[r, col(t, k)] * w(t, k, n)
// over reduction rows k = 0..nk-1 of output tile t: the dense baseline with
// col(t, k) = k and w the dense (K, N) weight; the block-VUSA product with
// col(t, k) = row_idx[t, k] (the gather, the paper's SPE -> MAC shifter) and
// w its packed job rows.  Only the operand loaders differ, so on the card
// the two kernels are the paper's A/B pair: the same array, with and
// without the gather.
//
// One block computes a BM x BN output tile (BN = 128 = one block-VUSA
// output tile) with NT = 128 threads: thread (tx, ty) of the 16 x 8 grid
// owns rows ty*TM .. ty*TM+TM-1 (TM = BM / 8) and columns tx*4..tx*4+3 and
// 64+tx*4..64+tx*4+3 (two float4 reads of a shared row, conflict-free).
// The reduction walks stages of KS = 32 rows: the block stages its BM x KS
// slice of x (k-major, row stride BM + 4, so a warp's 8 k x 4 row store
// hits 32 distinct banks while its global reads stay 32-byte sectors) and
// the KS x BN weight rows (eight float4 a thread) in shared memory, then
// every thread runs its TM x 8 outer products over the stage.  Every global
// load of a stage is issued into registers before any is used, and the
// next stage's loads are issued before the current stage's products, so
// their latency overlaps the arithmetic (one stage in flight; no cp.async).
//
// Determinism: every output accumulates with fmaf over k = 0, 1, .., nk-1
// in that order, whatever BM, the grid or the batch size: no split-K and no
// atomics, so row r of the output never depends on the other rows.
//
// Not done yet (later work): deeper pipelines (cp.async / TMA), tensor cores
// (TF32 would also change the numerics against the fp32 plain versions),
// narrower column tiles for N < 128, more blocks for the small-batch GEMMs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_gemm {

constexpr int NT = 128;                   // threads per block: 16 column groups x 8 row groups
constexpr int BN = 128;                   // output columns per block
constexpr int KS = 32;                    // reduction rows per shared-memory stage
constexpr int WV = KS * BN / 4 / NT;      // float4 weight loads per thread per stage
constexpr int WROW4 = BN / 4;             // float4s per weight row

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int BM>
struct Stage {
  float xs[KS][BM + 4];  // x slice, k-major
  float ws[KS][BN];      // weight rows
};

// TM consecutive floats of a shared row, as float4 / float2 reads.
template <int TM>
__device__ __forceinline__ void load_rows(const float* p, float (&a)[TM]) {
  if constexpr (TM % 4 == 0) {
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
    }
  } else {
    static_assert(TM % 2 == 0, "rows per thread");
#pragma unroll
    for (int i = 0; i < TM; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      a[i] = v.x; a[i + 1] = v.y;
    }
  }
}

// Op supplies the operands of one product:
//   int nk;                                  reduction rows per tile
//   int ncols;                               valid output columns (bound of t*BN + n)
//   int x_col(int t, int k) const;           column of x for row k < nk of tile t
//   float4 w4(int t, int k, int c4) const;   weight row k < nk of tile t, columns
//                                            4*c4 .. 4*c4+3 of the tile (0 past the edge)
// x is (rows, ldx) of XT; out is (rows, ldo) of OT.
template <int BM, typename XT, typename OT, typename Op>
__global__ void __launch_bounds__(NT)
    tile_gemm_kernel(const XT* __restrict__ x, int ldx, OT* __restrict__ out, int ldo, int rows,
                     const Op op) {
  constexpr int TM = BM / 8;
  constexpr int XV = BM / 4;  // x loads per thread per stage
  __shared__ __align__(16) Stage<BM> s;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int t = blockIdx.y;
  const int r0 = blockIdx.x * BM;
  // staging slot of this thread: x stage row gk, rows gb, gb + 4, ...
  const int gk = (tid / 32) * 8 + tid % 8;
  const int gb = (tid % 32) / 8;

  float xr[XV];
  float4 wr[WV];
  auto fetch = [&](int k0) {  // issue every global load of the stage at k0
    const int nkk = min(KS, op.nk - k0);
    const int col = gk < nkk ? op.x_col(t, k0 + gk) : 0;
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int r = r0 + gb + 4 * i;
      xr[i] = (gk < nkk && r < rows) ? to_f32(x[(size_t)r * ldx + col]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < WV; ++i) {
      const int e = i * NT + tid;
      const int k = e / WROW4;
      wr[i] = k < nkk ? op.w4(t, k0 + k, e % WROW4) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  if (op.nk > 0) fetch(0);
  for (int k0 = 0; k0 < op.nk; k0 += KS) {
    const int nkk = min(KS, op.nk - k0);
#pragma unroll
    for (int i = 0; i < XV; ++i) s.xs[gk][gb + 4 * i] = xr[i];
#pragma unroll
    for (int i = 0; i < WV; ++i) {
      const int e = i * NT + tid;
      reinterpret_cast<float4*>(&s.ws[e / WROW4][0])[e % WROW4] = wr[i];
    }
    __syncthreads();
    if (k0 + KS < op.nk) fetch(k0 + KS);
#pragma unroll 4
    for (int kk = 0; kk < nkk; ++kk) {
      float a[TM];
      load_rows<TM>(&s.xs[kk][ty * TM], a);
      const float4 v0 = *reinterpret_cast<const float4*>(&s.ws[kk][tx * 4]);
      const float4 v1 = *reinterpret_cast<const float4*>(&s.ws[kk][64 + tx * 4]);
      const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], v[c], acc[i][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty * TM + i;
    if (r >= rows) continue;
    OT* row = out + (size_t)r * ldo;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = t * BN + h * 64 + tx * 4;
      const float* v = &acc[i][h * 4];
      if constexpr (sizeof(OT) == sizeof(float)) {
        if (ldo % 4 == 0 && n + 3 < op.ncols) {  // 16-byte aligned: one vector store
          *reinterpret_cast<float4*>(row + n) = make_float4(v[0], v[1], v[2], v[3]);
          continue;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (n + c < op.ncols) store_out(row + n + c, v[c]);
    }
  }
}

// BM = 64 when that gives at least one block per SM, else BM = 16 (four
// times the blocks for the small-batch GEMMs of the deep layers).
template <typename XT, typename OT, typename Op>
cudaError_t launch(const XT* x, int ldx, OT* out, int ldo, int rows, int tiles, const Op& op,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long blocks64 = (long)((rows + 63) / 64) * tiles;
  if (blocks64 >= sms) {
    const dim3 grid((rows + 63) / 64, tiles);
    tile_gemm_kernel<64, XT, OT, Op><<<grid, NT, 0, stream>>>(x, ldx, out, ldo, rows, op);
  } else {
    const dim3 grid((rows + 15) / 16, tiles);
    tile_gemm_kernel<16, XT, OT, Op><<<grid, NT, 0, stream>>>(x, ldx, out, ldo, rows, op);
  }
  return cudaGetLastError();
}

}  // namespace tile_gemm
