// Clipped, summed weight gradient of a linear layer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `clip_reduce` of src/repro/kernels/clip_reduce.py
// (`_kernel`, launched by `pl.pallas_call` in `clip_reduce`). It computes
// the same function: for a (B, T, din), g (B, T, dout), float or bfloat16,
// and per-example clip factors c (B,) float,
//
//     out[i, j] = sum_r a[r, i] * (c[r / T] * g[r, j])   over the R = B T rows
//
// i.e. sum_b c_b A_bᵀ G_b, as float (din, dout).
//
// Design. The TPU ran grid (i, j, r) with the row axis r innermost and
// sequential, carrying the (bi x bj) accumulator in VMEM across r steps.
// Here one block owns one 128 x 128 output tile and loops over all R rows
// itself, 16 rows per step: it stages a[r0:r0+16, i-tile] and g[r0:r0+16,
// j-tile] in shared memory (both are row-major along the features, so the
// loads are coalesced and no transpose is needed), and each of the 256
// threads accumulates an 8 x 8 block of outputs in registers from
// float4 reads of shared memory. No split over rows and no atomics: every
// output is summed by one thread in row order, so the result is
// deterministic. Rows past R and features past din / dout load as zero.
//
// The clip factor is applied to g in float as the tile is staged, never
// rounded to bfloat16 or TF32 (the sensitivity bound needs the factor
// exact: see repro/core/ghost.py:clipped_sum_linear). A tensor-core
// version must keep that property: take A_bᵀ G_b per example from bf16
// products with f32 accumulation, then scale in f32.
//
// Bound. 2 R din dout operations against (R din + R dout) input elements
// and a din x dout float output: for the training path's linears
// (R = 2048) hundreds of operations per byte, so at the bf16 tensor-core
// rate the operations bound it. This first version runs CUDA-core f32
// FMAs (67 TFLOP/s peak on an H100 SXM), so it is at least 15x slower
// than that bound by construction; wgmma comes later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
clip_reduce_kernel(const T* __restrict__ a, const T* __restrict__ g,
                   const float* __restrict__ factors, float* __restrict__ out,
                   int R, int t_len, int din, int dout) {
  __shared__ __align__(16) float as[kBR][kBI];
  __shared__ __align__(16) float gs[kBR][kBJ];
  const int i0 = blockIdx.y * kBI, j0 = blockIdx.x * kBJ;
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

template <typename T>
int launch(const void* a, const void* g, const void* factors, void* out,
           int B, int t_len, int din, int dout, cudaStream_t stream) {
  const dim3 grid((dout + kBJ - 1) / kBJ, (din + kBI - 1) / kBI);
  clip_reduce_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(g),
      static_cast<const float*>(factors), static_cast<float*>(out),
      B * t_len, t_len, din, dout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// factors: B floats; out: din * dout floats. is_bf16: 1 for bfloat16 a
// and g, 0 for float.
int clip_reduce_launch(const void* a, const void* g, const void* factors,
                       void* out, int B, int t_len, int din, int dout,
                       int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(a, g, factors, out, B, t_len, din, dout, s);
  return launch<float>(a, g, factors, out, B, t_len, din, dout, s);
}

}  // extern "C"
