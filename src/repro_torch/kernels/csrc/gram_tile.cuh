// The float32 path of ghost_norm.cu and ghost_norm_blocked.cu, on the CUDA
// cores (their bfloat16 path is gram_mma.cuh): one block of 256 threads
// computes the (32 x 32) block X_i X_jᵀ of two 32-row tiles i, j of one
// example's (T, ld) row-major matrix, over d of its columns, in float
// registers (a 2 x 2 block of outputs per thread).
//
// The block loops over the d columns itself, staging 32 x 32 chunks of
// rows i and j in shared memory, transposed, with an odd row stride so the
// transposed stores hit distinct banks. Rows past T and columns past d
// load as zero, so ragged T and narrow column ranges need no padding.
// `block_sum` then reduces one float per thread in a fixed order, so both
// kernels that include this file are deterministic; gram_mma.cuh uses it
// and `pair_of` too.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace gram_tile {

constexpr int kTile = 32;   // sequence rows per tile
constexpr int kChunk = 32;  // columns staged per step
// odd row stride: transposed stores hit distinct banks
constexpr int kPad = kTile + 1;
// 16 x 16 threads, a 2 x 2 block of outputs each
constexpr int kThreads = 256;
static_assert(kTile == 32 && kThreads == 256, "thread map assumes 16x16");

// Adds the gram block X_i X_jᵀ into acc: x points at column 0 of the
// range in row 0 of one example, ld is the row stride in elements, d the
// number of columns in the range; acc[m][n] is entry (ty + 16 m, tx + 16 n).
__device__ inline void gram_block(const float* __restrict__ x, int t_len,
                                  int ld, int d, int i0, int j0,
                                  float (*xi)[kPad], float (*xj)[kPad],
                                  float acc[2][2]) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk, k = e - r * kChunk, f = k0 + k;
      float vi = 0.f, vj = 0.f;
      if (f < d) {
        if (i0 + r < t_len) vi = x[static_cast<size_t>(i0 + r) * ld + f];
        if (j0 + r < t_len) vj = x[static_cast<size_t>(j0 + r) * ld + f];
      }
      xi[k][r] = vi;
      xj[k][r] = vj;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const float a0 = xi[k][ty], a1 = xi[k][ty + 16];
      const float b0 = xj[k][tx], b1 = xj[k][tx + 16];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
}

// <p, q> of two threads' 2 x 2 blocks.
__device__ __forceinline__ float dot4(const float p[2][2],
                                      const float q[2][2]) {
  return p[0][0] * q[0][0] + p[0][1] * q[0][1] + p[1][0] * q[1][0] +
         p[1][1] * q[1][1];
}

// The block's sum of one float per thread, in a fixed order (warp
// shuffles, then warp 0..7 in turn); valid in thread 0 only. warp_sum:
// kThreads / 32 floats of shared memory. Ends with a barrier, so the
// caller may reuse warp_sum right after.
__device__ __forceinline__ float block_sum(float s, float* warp_sum) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const int tid = threadIdx.x;
  if (tid % 32 == 0) warp_sum[tid / 32] = s;
  __syncthreads();
  float total = 0.f;
  if (tid == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
  __syncthreads();
  return total;
}

// Tile pair p of the upper triangle (row by row) -> (i, j >= i).
__device__ __forceinline__ void pair_of(int p, int nt, int* i, int* j) {
  int ii = 0, rest = p;
  while (rest >= nt - ii) {
    rest -= nt - ii;
    ++ii;
  }
  *i = ii;
  *j = ii + rest;
}

}  // namespace gram_tile
