// The scaled contraction shared by clip_reduce.cu and scale_contract.cu:
// one block computes one 128 x 128 tile of
//
//     out[i, j] = sum_r a[r, i] * (c[r / T] * g[r, j])   over the R = B T rows
//
// for a (R, din), g (R, dout), float or bfloat16, factors c (B,) float and
// a float (din, dout) output, all row-major and contiguous.
//
// The block loops over all R rows itself, 16 rows per step: it stages
// a[r0:r0+16, i-tile] and g[r0:r0+16, j-tile] in shared memory (both are
// row-major along the features, so the loads are coalesced and no
// transpose is needed), and each of the 256 threads accumulates an 8 x 8
// block of outputs in registers from float4 reads of shared memory. No
// split over rows and no atomics: every output is summed by one thread in
// row order, so the result is deterministic, and both kernels that include
// this file sum in the same order. Rows past R and features past din /
// dout load as zero.
//
// The clip factor is applied to g in float as the tile is staged, never
// rounded to bfloat16 or TF32 (the sensitivity bound needs the factor
// exact: see repro/core/ghost.py:clipped_sum_linear). A tensor-core
// version must keep that property: take A_bᵀ G_b per example from bf16
// products with f32 accumulation, then scale in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace contract_tile {

constexpr int kBI = 128;  // din rows of the output tile
constexpr int kBJ = 128;  // dout columns of the output tile
constexpr int kBR = 16;   // input rows staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
static_assert(kBI == 128 && kBJ == 128 && kThreads == 256,
              "thread map assumes 16x16 threads of two 4-wide halves");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Output offset of this thread's m-th row (or column) within the tile:
// two 4-wide groups 64 apart, so a warp's float4 reads cover distinct banks.
__device__ __forceinline__ int lane_offset(int t, int m) {
  return (m < 4) ? t * 4 + m : 64 + t * 4 + (m - 4);
}

// The tile at (i0, j0) of one contraction; called by every thread of a
// kThreads-thread block.
template <typename T>
__device__ __forceinline__ void contract(const T* __restrict__ a,
                                         const T* __restrict__ g,
                                         const float* __restrict__ factors,
                                         float* __restrict__ out, int R,
                                         int t_len, int din, int dout, int i0,
                                         int j0) {
  __shared__ __align__(16) float as[kBR][kBI];
  __shared__ __align__(16) float gs[kBR][kBJ];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.f;

  for (int r0 = 0; r0 < R; r0 += kBR) {
    for (int e = tid; e < kBR * kBI; e += kThreads) {
      const int rr = e / kBI, ii = e - rr * kBI, r = r0 + rr, i = i0 + ii;
      as[rr][ii] = (r < R && i < din)
                       ? to_f32(a[static_cast<size_t>(r) * din + i])
                       : 0.f;
    }
    for (int e = tid; e < kBR * kBJ; e += kThreads) {
      const int rr = e / kBJ, jj = e - rr * kBJ, r = r0 + rr, j = j0 + jj;
      gs[rr][jj] = (r < R && j < dout)
                       ? factors[r / t_len] *
                             to_f32(g[static_cast<size_t>(r) * dout + j])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBR; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&gs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&gs[k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int i = i0 + lane_offset(ty, m);
    if (i >= din) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int j = j0 + lane_offset(tx, n);
      if (j < dout) out[static_cast<size_t>(i) * dout + j] = acc[m][n];
    }
  }
}

}  // namespace contract_tile
