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
// Here grid z runs the S slices (times the split over examples, where a
// slice has few tiles) and one block owns one output tile of one slice,
// with the tile loops of clip_reduce.cu: bfloat16 inputs on the tensor
// cores (contract_mma.cuh: wgmma over a TMA-filled ring, each example's
// A_bᵀ G_b scaled by its factor in f32 at the example's end), float32 on
// the CUDA cores (contract_tile.cuh). The S B examples are one 3-D tensor
// map of each operand. No atomics: deterministic, and summed in the same
// order as clip_reduce (the split depends on B, din and dout only), so
// the BK and two-pass executions differ on the card only where their
// inputs do.
//
// Bound. 2 S B T din dout operations against the inputs read once and the
// f32 output written once: at B T = 2048 hundreds of operations per byte,
// so the bf16 tensor-core rate bounds it (for qwen3-4b's stacked gate_up,
// 7.4 ms on an H100 SXM).
#include "contract_mma.cuh"
#include "contract_tile.cuh"

namespace {

__global__ void __launch_bounds__(contract_tile::kThreads)
scale_contract_f32(const float* __restrict__ a, const float* __restrict__ g,
                   const float* __restrict__ factors, float* __restrict__ out,
                   int B, int t_len, int din, int dout) {
  const size_t s = blockIdx.z;
  const size_t rows = static_cast<size_t>(B) * t_len;
  contract_tile::contract(
      a + s * rows * din, g + s * rows * dout, factors + s * B,
      out + s * static_cast<size_t>(din) * dout, B * t_len, t_len, din, dout,
      1, dout, 0, blockIdx.y * contract_tile::kBI,
      blockIdx.x * contract_tile::kBJ);
}

}  // namespace

extern "C" {

// Partial tiles per slice that scale_contract_launch needs in `part`: 1
// means none.
int scale_contract_splits(int B, int din, int dout, int is_bf16) {
  return is_bf16 ? contract_mma::splits(B, din, dout) : 1;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// contract_mma's codes past 10000 for a refused tensor map. factors: S * B
// floats; out: S * din * dout floats; part: S * splits * din * dout floats
// (unused when splits is 1). is_bf16: 1 for bfloat16 a and g, 0 for float.
int scale_contract_launch(const void* a, const void* g, const void* factors,
                          void* out, void* part, int S, int B, int t_len,
                          int din, int dout, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return contract_mma::launch(a, g, static_cast<const float*>(factors),
                                static_cast<float*>(out),
                                static_cast<float*>(part), S, B, t_len, din,
                                dout, 1, 0, s);
  const dim3 grid((dout + contract_tile::kBJ - 1) / contract_tile::kBJ,
                  (din + contract_tile::kBI - 1) / contract_tile::kBI, S);
  scale_contract_f32<<<grid, contract_tile::kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(g),
      static_cast<const float*>(factors), static_cast<float*>(out), B, t_len,
      din, dout);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
