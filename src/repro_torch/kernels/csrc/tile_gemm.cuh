// Tiled GEMM skeleton for Hopper (sm_90a), shared by the block-VUSA product
// (vusa_spmm.cu) and the dense baseline (dense_matmul.cu).
//
// Both kernels compute out[r, n] = sum_k x[r, col(n, k)] * w(n, k) over the
// reduction rows k = 0..nk-1 of output column n: the dense baseline with
// col = k and w the dense (K, N) weight; the block-VUSA product with col =
// row_idx[t, k] (the gather, the paper's SPE -> MAC shifter) and w its
// packed job rows, t the 128-lane output tile of n.  Only the operand
// loaders differ, so on the card the two kernels are the paper's A/B pair:
// the same array, with and without the gather.
//
// What bounds them on this card.  At the paper's workloads (B = 49 ..
// 12,544 output pixels) the fp32 operations, not the bytes, bound most
// GEMMs, but none is large: 0.01 to 0.47 GFLOP each, so a GEMM lasts a few
// microseconds and what decides its time is whether enough blocks are in
// flight to hide the latency of each block's loads and dependent products.
// The deep layers have few output tiles (49 x 512 at ResNet-18's layer4)
// and long reductions (K = 4608): a grid of output tiles alone leaves most
// of the 132 SMs idle while each block walks 144 serial stages.  Inside a
// block, the issue slots, not the tensor cores, are the scarce resource:
// every fragment value is split in two before three products use it.
//
// The design.
// - Tiles: a block of NT = 128 threads (4 warps side by side along the
//   columns, each 32 x 16) computes BM = 32 rows by BN = 64 columns: no idle
//   lanes at C = 64, and twice the tiles of 128-column ones for the wide
//   small-B layers.  The tile does not depend on the GEMM.
// - Ordered K-split: the reduction's stages of KS = 32 rows are cut into S
//   slices of ceil(stages / S) consecutive stages (blockIdx.z); for the
//   block-VUSA product a slice is a run of consecutive jobs, for the dense
//   product a K range.  With S = 1 the block writes the output; else it
//   writes an fp32 partial to the workspace (S, rows, ncols) and a second
//   launch (reduce_slices, a programmatic dependent launch, so its launch
//   overlaps the tile kernel's tail) sums the partials in slice order
//   0..S-1 and rounds once to the output type.  No atomics.  The host
//   (kernels/tile_plan.py) picks S from nk alone: 1 up to 8 stages, else
//   slices of at most 4 stages (S = 36 at K = 4608); never from the number
//   of rows.  It passes the tile and stage sizes it assumed (BM, BN, KS)
//   with S, and `launch` refuses any that differ from the constants below.
// - A ring of NS = 3 stages in dynamic shared memory (41.5 KB: five blocks
//   an SM, and under the 48 KB a launch takes without opting in), filled
//   with cp.async (16-byte copies of weight rows and of dense fp32 x rows,
//   4-byte copies of gathered x elements; the ragged edges zero-filled by
//   the copy itself), two stages in flight while one is computed.  The
//   block-VUSA loader reads the row_idx entries of a stage one iteration
//   before it issues that stage's copies.  bf16 operands take plain loads
//   into the ring (widened to fp32 exactly).
// - Split-precision tensor cores ("3xTF32"): each fp32 operand v is split
//   into hi = tf32(v) and lo = tf32(v - hi), each cut toward zero (two
//   integer ops; cvt.rna took more issue slots than the products it fed),
//   and every m16n8k8 product accumulates lo_x*hi_w and hi_x*lo_w into one
//   fp32 accumulator and hi_x*hi_w into another (two independent mma.sync
//   chains), which meet once, in the epilogue: about 2^-20 relative error
//   per product against one TF32 pass's 2^-10.  bf16 operands are exact in
//   TF32 (lo = 0).
//
// Contracts.  One fixed reduction order per output for a given (nk, plan):
// stages in order inside a slice, the 8-row steps in order inside a stage,
// the products in the order above, then the slices in order.  Rows are
// independent of each other and of the number of rows (a product never
// mixes rows, and the plan does not see the row count).  Every reduction
// row inside nk is multiplied, padding rows (row_idx 0, value 0) included,
// so a NaN in x[:, 0] reaches exactly the outputs it reaches in the plain
// version.  Rows past nk, past the row count or past the valid width are
// zero-filled on both operands.  The wrapper may run a call's rows as
// several launches (row chunks whose partials fit a fixed workspace);
// since rows are independent, that changes no bit.
//
// Non-finite values: where v is not finite, hi = v and lo = 0, so hi_x*hi_w
// carries every inf and NaN of the plain product.  A cross term can still
// meet inf * 0 (an inf against an operand whose lo is 0, that is, a value
// TF32 holds exactly), so where the hi_x*hi_w sum is +-inf the epilogue
// takes it alone (a finite addend would not change it): a NaN or a
// +-inf operand then reaches exactly the outputs, with the signs, that it
// reaches in the plain fp32 version.  One exception is left: a weight (or
// x) below 2^-136 in magnitude, a subnormal of which TF32 keeps no bit, is
// multiplied as 0, so against an inf it gives NaN where fp32 gives +-inf.
//
// Launch accounting: every kernel launch that the CUDA runtime accepts adds
// one to `cuda_launches`; each library built on this header (vusa_spmm.cu,
// dense_matmul.cu) has its own count and exports it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "ptx.cuh"

namespace tile_gemm {

constexpr int NT = 128;      // threads per block: 4 warps along the columns
constexpr int BM = 32;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int KS = 32;       // reduction rows per stage
constexpr int NS = 3;        // stages in the shared-memory ring
constexpr int XLD = KS + 4;  // x tile row stride: a fragment read hits 32 banks
constexpr int WLD = BN + 8;  // weight tile row stride: a fragment read hits 32 banks

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One ring slot: the stage's x tile (BM rows of KS columns) and weight
// tile (KS rows of BN columns), both row-major and multiples of 16 bytes.
struct Slot {
  float xs[BM][XLD];
  float ws[KS][WLD];
};
constexpr size_t SMEM_BYTES = NS * sizeof(Slot);
static_assert(SMEM_BYTES <= 48 * 1024, "above 48 KB the ring needs cudaFuncSetAttribute");

// Kernel launches accepted by the runtime (see the note above).  Static, so
// each library has its own: an inline variable would be one symbol that the
// dynamic linker shares between the two libraries of a process.
static std::atomic<unsigned long long> cuda_launches{0};

// What the host passes besides the operands.
struct Problem {
  int rows;      // output rows (B or M)
  int ldx;       // x row stride, elements
  bool x_vec;    // dense fp32 x with 16-byte aligned rows: 16-byte copies
  int nk;        // reduction rows per output column
  int ncols;     // valid output columns = the output's row stride
  int slices;    // S
  float* part;   // (S, rows, ncols) fp32 partials, used when S > 1
};

// hi = tf32(v), lo = tf32(v - hi), each cut toward zero (the low 13
// mantissa bits cleared); hi = v and lo = 0 where v is not finite.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  constexpr uint32_t TF32 = 0xffffe000u;
  const uint32_t b = __float_as_uint(v);
  const bool finite = fabsf(v) <= 3.402823466e38f;
  hi = finite ? b & TF32 : b;
  lo = finite ? __float_as_uint(v - __uint_as_float(b & TF32)) & TF32 : 0u;
}

// Op supplies the operands (see vusa_spmm.cu and dense_matmul.cu):
//   static constexpr bool kGather;          x columns through an index
//   using WT = ...;                          weight element type
//   bool w_vec;                              16-byte aligned fp32 weight rows
//   int x_col(int n0, int k) const;          x column of reduction row k
//                                            (k < nk) for the block whose
//                                            first output column is n0
//   const WT* w_row(int n0, int k) const;    weight row k from column n0 on
template <typename XT, typename OT, typename Op>
__global__ void __launch_bounds__(NT)
    tile_gemm_kernel(const XT* __restrict__ x, OT* __restrict__ out, const Problem pb,
                     const Op op) {
  using WT = typename Op::WT;
  constexpr int WN = BN / 4;  // columns per warp
  constexpr int NI = WN / 8;  // n8 fragments per warp
  constexpr int MI = BM / 16; // m16 fragments per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Slot* ring = reinterpret_cast<Slot*>(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int stages = (pb.nk + KS - 1) / KS;
  const int per = (stages + pb.slices - 1) / pb.slices;
  const int s0 = min((int)blockIdx.z * per, stages);
  const int nst = min(s0 + per, stages) - s0;  // stages of this slice
  const int nvalid = min(BN, pb.ncols - n0);   // valid columns of the tile

  // In the element loaders lane k copies reduction row k of a stage (for x
  // rows warp, warp + 4, ...), so a thread needs one x column per stage.
  auto x_col = [&](int s) {
    const int k = s * KS + lane;
    return (s < s0 + nst && k < pb.nk) ? op.x_col(n0, k) : 0;
  };

  auto load = [&](int s, Slot& slot, int col) {
    const int kb = s * KS;
    const int kval = min(KS, pb.nk - kb);  // valid reduction rows of the stage
    // x tile
    bool done = false;
    if constexpr (!Op::kGather && std::is_same<XT, float>::value) {
      if (pb.x_vec) {  // 8 16-byte chunks a row, 2 a thread
#pragma unroll
        for (int i = 0; i < BM * KS / 4 / NT; ++i) {
          const int e = tid + i * NT, r = e / (KS / 4), c = 4 * (e % (KS / 4));
          const bool in = r0 + r < pb.rows;
          const int bytes = in ? 4 * max(0, min(4, kval - c)) : 0;
          ptx::cp_async16(&slot.xs[r][c], bytes ? x + (size_t)(r0 + r) * pb.ldx + kb + c : x,
                          bytes);
        }
        done = true;
      }
    }
    if (!done) {  // element by element: lane = reduction row
#pragma unroll
      for (int i = 0; i < BM / 4; ++i) {
        const int r = warp + 4 * i;
        const bool in = lane < kval && r0 + r < pb.rows;
        const XT* src = x + (size_t)(r0 + r) * pb.ldx + col;
        if constexpr (std::is_same<XT, float>::value)
          ptx::cp_async4(&slot.xs[r][lane], in ? src : x, in ? 4 : 0);
        else
          slot.xs[r][lane] = in ? to_f32(*src) : 0.f;
      }
    }
    // weight tile
    bool w_vec = false;
    if constexpr (std::is_same<WT, float>::value) w_vec = op.w_vec;
    if (w_vec) {  // 16-byte chunks
#pragma unroll
      for (int i = 0; i < KS * BN / 4 / NT; ++i) {
        const int e = tid + i * NT, k = e / (BN / 4), c = 4 * (e % (BN / 4));
        const int bytes = k < kval ? 4 * max(0, min(4, nvalid - c)) : 0;
        ptx::cp_async16(&slot.ws[k][c], bytes ? op.w_row(n0, kb + k) + c : op.w_row(n0, 0),
                        bytes);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < KS * BN / NT; ++i) {
        const int e = tid + i * NT, k = e / BN, c = e % BN;
        const bool in = k < kval && c < nvalid;
        const WT* src = in ? op.w_row(n0, kb + k) + c : op.w_row(n0, 0);
        if constexpr (std::is_same<WT, float>::value)
          ptx::cp_async4(&slot.ws[k][c], src, in ? 4 : 0);
        else
          slot.ws[k][c] = in ? to_f32(*src) : 0.f;
      }
    }
  };

  // hi_x*hi_w and the two cross terms accumulate apart (two independent
  // mma chains per fragment) and meet once, in the epilogue
  float acc[MI][NI][4], accx[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = accx[mi][ni][c] = 0.f;

  const int g = lane / 4, q = lane % 4;  // fragment row group, column in group
  const int wn = warp * WN;

  // prologue: NS - 1 stages in flight, then the next stage's x columns
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j < nst) load(s0 + j, ring[j], x_col(s0 + j));
    ptx::cp_async_commit();
  }
  int col_next = x_col(s0 + NS - 1);

  for (int i = 0; i < nst; ++i) {
    ptx::cp_async_wait<NS - 2>();  // stage i has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and stage i - 1 is consumed
    const int nxt = i + NS - 1;
    if (nxt < nst) load(s0 + nxt, ring[nxt % NS], col_next);
    ptx::cp_async_commit();
    col_next = x_col(s0 + nxt + 1);  // the gather's index read overlaps stage i

    const Slot& sl = ring[i % NS];
#pragma unroll
    for (int kk = 0; kk < KS; kk += 8) {
      uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = mi * 16 + g;
        split(sl.xs[r][kk + q], ah[mi][0], al[mi][0]);
        split(sl.xs[r + 8][kk + q], ah[mi][1], al[mi][1]);
        split(sl.xs[r][kk + q + 4], ah[mi][2], al[mi][2]);
        split(sl.xs[r + 8][kk + q + 4], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int c = wn + ni * 8 + g;
        split(sl.ws[kk + q][c], bh[ni][0], bl[ni][0]);
        split(sl.ws[kk + q + 4][c], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          ptx::mma_tf32(accx[mi][ni], al[mi], bh[ni]);
          ptx::mma_tf32(accx[mi][ni], ah[mi], bl[ni]);
          ptx::mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
        }
    }
  }

  // epilogue: fragment element c of (mi, ni) is row mi*16 + g (+8 for c >= 2),
  // column wn + ni*8 + 2q + (c & 1); with S > 1 the block's fp32 partial,
  // which reduce_slices sums
  const bool whole = pb.slices == 1;
  float* part = pb.part + (size_t)blockIdx.z * pb.rows * pb.ncols;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + mi * 16 + g + 8 * h;
      if (r >= pb.rows) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = wn + ni * 8 + 2 * q;
        const size_t o = (size_t)r * pb.ncols + n0 + n;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (n + c >= nvalid) continue;
          // where hi*hi is +-inf the cross terms may hold inf * 0 (see the note)
          const float hh = acc[mi][ni][2 * h + c];
          const float v = isinf(hh) ? hh : accx[mi][ni][2 * h + c] + hh;
          if (whole)
            store_out(out + o + c, v);
          else
            part[o + c] = v;
        }
      }
    }
}

// out[i] = part[0][i] + part[1][i] + ... + part[S-1][i], in that order,
// rounded once to OT.  Launched as a programmatic dependent of the tile
// kernel: its launch overlaps the tile kernel's tail, and it waits for the
// tile kernel's partials before it reads them.
template <typename OT>
__global__ void reduce_slices(const float* __restrict__ part, OT* __restrict__ out, size_t n,
                              int slices) {
  ptx::grid_dependency_wait();
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < slices; ++z) s += part[(size_t)z * n + i];
    store_out(out + i, s);
  }
}

// Launch the plan (slices, bm, bn, ks) that the host computed: the tile
// kernel, then, with more than one slice, the ordered sum of the partials.
template <typename XT, typename OT, typename Op>
cudaError_t launch(const XT* x, OT* out, const Problem& pb, int bm, int bn, int ks, const Op& op,
                   cudaStream_t stream) {
  if (bm != BM || bn != BN || ks != KS || pb.slices < 1 || pb.slices > 65535 ||
      (pb.slices > 1 && pb.part == nullptr) || (pb.ncols + BN - 1) / BN > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((pb.rows + BM - 1) / BM, (pb.ncols + BN - 1) / BN, pb.slices);
  tile_gemm_kernel<XT, OT, Op><<<grid, NT, SMEM_BYTES, stream>>>(x, out, pb, op);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ++cuda_launches;
  if (pb.slices == 1) return cudaSuccess;
  const size_t n = (size_t)pb.rows * pb.ncols;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  cudaLaunchAttribute dependent[1];
  dependent[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cfg.attrs = dependent;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, reduce_slices<OT>, static_cast<const float*>(pb.part), out, n,
                         pb.slices);
  if (e == cudaSuccess) ++cuda_launches;
  return e;
}

}  // namespace tile_gemm
