// The book-keeping (BK) epilogue's scaled contraction, for Hopper (sm_90a).
//
// Replaces the TPU kernel `scale_contract` of src/repro/kernels/bk.py
// (`_kernel`, launched by `pl.pallas_call` in `scale_contract`). For
// cached residuals a (S, B, T, din) and g (S, B, T, dout), float or
// bfloat16, and clip factors f (S, B) float, it computes
//
//     out[s] = sum_b f[s, b] A[s, b]ᵀ G[s, b]        (S, din, dout) float
//
// in one launch: slice s is one layer of a stacked weight, so the whole
// epilogue of a stacked leaf is one call.
//
// Design. The TPU ran grid (S, i, j, r) with the row axis r innermost and
// sequential, carrying the (bi x bj) accumulator in VMEM across r steps.
// Here the grid is (dout tiles, din tiles, S): one block owns one 128 x
// 128 output tile of one slice and loops over all B T rows of that slice
// itself, with the tile loop of clip_reduce.cu (contract_tile.cuh). No
// split over rows, no atomics: deterministic, and summed in the same order
// as clip_reduce, so the BK and two-pass executions differ on the card
// only where their inputs do. Ragged rows, din and dout are masked in the
// loads (the TPU padded them with zeros). The factor multiplies g in f32
// as it is staged.
//
// Bound. 2 S B T din dout operations against the inputs read once and the
// f32 output written once: at B T = 2048 hundreds of operations per byte,
// so the bf16 tensor-core rate bounds it (for qwen3-4b's stacked gate_up,
// 7.4 ms). This version runs CUDA-core f32 FMAs (67 TFLOP/s peak on an
// H100 SXM): at least 15x that bound by construction; wgmma comes later,
// for clip_reduce and this kernel together.
#include "contract_tile.cuh"

namespace {

using contract_tile::kBI;
using contract_tile::kBJ;
using contract_tile::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
scale_contract_kernel(const T* __restrict__ a, const T* __restrict__ g,
                      const float* __restrict__ factors,
                      float* __restrict__ out, int B, int t_len, int din,
                      int dout) {
  const size_t s = blockIdx.z;
  const size_t rows = static_cast<size_t>(B) * t_len;
  contract_tile::contract<T>(a + s * rows * din, g + s * rows * dout,
                             factors + s * B,
                             out + s * static_cast<size_t>(din) * dout,
                             B * t_len, t_len, din, dout, blockIdx.y * kBI,
                             blockIdx.x * kBJ);
}

template <typename T>
int launch(const void* a, const void* g, const void* factors, void* out,
           int S, int B, int t_len, int din, int dout, cudaStream_t stream) {
  const dim3 grid((dout + kBJ - 1) / kBJ, (din + kBI - 1) / kBI, S);
  scale_contract_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(g),
      static_cast<const float*>(factors), static_cast<float*>(out), B, t_len,
      din, dout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// factors: S * B floats; out: S * din * dout floats. is_bf16: 1 for
// bfloat16 a and g, 0 for float.
int scale_contract_launch(const void* a, const void* g, const void* factors,
                          void* out, int S, int B, int t_len, int din,
                          int dout, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(a, g, factors, out, S, B, t_len, din, dout,
                                 s);
  return launch<float>(a, g, factors, out, S, B, t_len, din, dout, s);
}

}  // extern "C"
