// Clipped, summed weight gradient of a linear layer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `clip_reduce` of src/repro/kernels/clip_reduce.py
// (`_kernel`, launched by `pl.pallas_call` in `clip_reduce`). It computes
// the same function: for a (B, T, din), g (B, T, dout), float or bfloat16,
// and per-example clip factors c (B,) float,
//
//     out[i, j] = sum_b c_b sum_t a[b, t, i] g[b, t, j]      (din, dout) float
//
// i.e. sum_b c_b A_bᵀ G_b. With per-block factors c (B, M) (per-shard
// clipping) output (i, j) takes c[b, j / (dout / M)] (axis "out") or
// c[b, i / (din / M)] (axis "in"): the reference's fold of the factors into
// the blocked operand followed by `clip_reduce`, in one call.
//
// Design. The TPU ran grid (i, j, r) with the row axis r innermost and
// sequential, carrying the (bi x bj) accumulator in VMEM across r steps.
// Here one block owns one output tile and loops over the rows itself.
// bfloat16 inputs run contract_mma.cuh: wgmma from a 4-stage ring filled
// by TMA, each example's A_bᵀ G_b summed in registers and scaled by its
// factor (per row or column block) in f32 at the example's end; a split
// over examples with an ordered second pass where a layer has few tiles
// (granite's router, 1536 -> 40). float32 inputs run the CUDA-core loop of
// contract_tile.cuh, the factor applied as the tile is staged. Both are
// deterministic (no atomics) and shared with scale_contract.cu.
//
// Bound. 2 B T din dout operations against (B T din + B T dout) input
// elements and a din x dout float output: for the training path's linears
// (B T = 2048) hundreds of operations per byte, so at the bf16
// tensor-core rate (989 TFLOP/s on an H100 SXM) the operations bound it;
// at granite's router (dout = 40) the bytes do.
#include "contract_mma.cuh"
#include "contract_tile.cuh"

namespace {

__global__ void __launch_bounds__(contract_tile::kThreads)
clip_reduce_f32(const float* __restrict__ a, const float* __restrict__ g,
                const float* __restrict__ factors, float* __restrict__ out,
                int R, int t_len, int din, int dout, int m_blocks,
                int block_w, int axis_in) {
  contract_tile::contract(a, g, factors, out, R, t_len, din, dout,
                                 m_blocks, block_w, axis_in,
                                 blockIdx.y * contract_tile::kBI,
                                 blockIdx.x * contract_tile::kBJ);
}

}  // namespace

extern "C" {

// Partial tiles per output that clip_reduce_launch needs in `part` (the
// split over examples of a layer with few output tiles): 1 means none.
int clip_reduce_splits(int B, int din, int dout, int is_bf16) {
  return is_bf16 ? contract_mma::splits(B, din, dout) : 1;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// contract_mma's codes past 10000 for a refused tensor map. factors: B * M
// floats; out: din * dout floats; part: splits * din * dout floats (unused
// when splits is 1). axis_in: 1 for blocks along din, 0 along dout. is_bf16:
// 1 for bfloat16 a and g (tensor cores), 0 for float.
int clip_reduce_launch(const void* a, const void* g, const void* factors,
                       void* out, void* part, int B, int t_len, int din,
                       int dout, int m_blocks, int axis_in, int is_bf16,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return contract_mma::launch(a, g, static_cast<const float*>(factors),
                                static_cast<float*>(out),
                                static_cast<float*>(part), 1, B, t_len, din,
                                dout, m_blocks, axis_in, s);
  const int in = m_blocks > 1 && axis_in;
  const int block_w = m_blocks == 1 ? dout : (in ? din : dout) / m_blocks;
  const dim3 grid((dout + contract_tile::kBJ - 1) / contract_tile::kBJ,
                  (din + contract_tile::kBI - 1) / contract_tile::kBI);
  clip_reduce_f32<<<grid, contract_tile::kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(g),
      static_cast<const float*>(factors), static_cast<float*>(out),
      B * t_len, t_len, din, dout, m_blocks, block_w, in);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
