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
// itself (contract_tile.cuh, shared with scale_contract.cu): no split over
// rows, no atomics, a deterministic result; the factor is applied to g in
// f32 as the tile is staged.
//
// Bound. 2 R din dout operations against (R din + R dout) input elements
// and a din x dout float output: for the training path's linears
// (R = 2048) hundreds of operations per byte, so at the bf16 tensor-core
// rate the operations bound it. This first version runs CUDA-core f32
// FMAs (67 TFLOP/s peak on an H100 SXM), so it is at least 15x slower
// than that bound by construction; wgmma comes later.
#include "contract_tile.cuh"

namespace {

using contract_tile::kBI;
using contract_tile::kBJ;
using contract_tile::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
clip_reduce_kernel(const T* __restrict__ a, const T* __restrict__ g,
                   const float* __restrict__ factors, float* __restrict__ out,
                   int R, int t_len, int din, int dout) {
  contract_tile::contract<T>(a, g, factors, out, R, t_len, din, dout,
                             blockIdx.y * kBI, blockIdx.x * kBJ);
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
