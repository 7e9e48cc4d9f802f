// The scaled contraction of clip_reduce.cu and scale_contract.cu for
// float32 inputs, on the CUDA cores (bfloat16 inputs take the tensor-core
// loop of contract_mma.cuh): one block computes one 128 x 128 tile of
//
//     out[i, j] = sum_r a[r, i] * (c[r / T] * g[r, j])   over the R = B T rows
//
// for a (R, din), g (R, dout), float, factors c (B,) float and a float
// (din, dout) output, all row-major and contiguous. With M > 1 blocks the
// factors are (B, M): row r's factor of column j is c[r / T, j / W]
// (axis "out", W = dout / M), or a's rows take c[r / T, i / W] (axis
// "in", W = din / M) and g is staged unscaled.
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
// The clip factor is applied to g (or a) in float as the tile is staged,
// never rounded to bfloat16 or TF32 (the sensitivity bound needs the
// factor exact: see repro/core/ghost.py:clipped_sum_linear).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace contract_tile {

constexpr int kBI = 128;  // din rows of the output tile
constexpr int kBJ = 128;  // dout columns of the output tile
constexpr int kBR = 16;   // input rows staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
static_assert(kBI == 128 && kBJ == 128 && kThreads == 256,
              "thread map assumes 16x16 threads of two 4-wide halves");

// Output offset of this thread's m-th row (or column) within the tile:
// two 4-wide groups 64 apart, so a warp's float4 reads cover distinct banks.
__device__ __forceinline__ int lane_offset(int t, int m) {
  return (m < 4) ? t * 4 + m : 64 + t * 4 + (m - 4);
}

// The tile at (i0, j0) of one contraction; called by every thread of a
// kThreads-thread block.
__device__ __forceinline__ void contract(const float* __restrict__ a,
                                         const float* __restrict__ g,
                                         const float* __restrict__ factors,
                                         float* __restrict__ out, int R,
                                         int t_len, int din, int dout,
                                         int m_blocks, int block_w,
                                         int axis_in, int i0, int j0) {
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
      as[rr][ii] =
          (r < R && i < din)
              ? (axis_in ? factors[(r / t_len) * m_blocks + i / block_w]
                         : 1.f) *
                    a[static_cast<size_t>(r) * din + i]
              : 0.f;
    }
    for (int e = tid; e < kBR * kBJ; e += kThreads) {
      const int rr = e / kBJ, jj = e - rr * kBJ, r = r0 + rr, j = j0 + jj;
      gs[rr][jj] =
          (r < R && j < dout)
              ? (axis_in ? 1.f
                         : factors[(r / t_len) * m_blocks + j / block_w]) *
                    g[static_cast<size_t>(r) * dout + j]
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
