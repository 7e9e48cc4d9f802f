// Per-example, per-block gradient norms² of a linear layer whose weight is
// split into M column ('out') or row ('in') blocks, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ghost_norm_blocked` of
// src/repro/kernels/ghost_norm.py (`_blocked_kernel`, launched by
// `pl.pallas_call` in `ghost_norm_blocked`). It computes the same
// function: for a (B, T, din) and g (B, T, dout), float or bfloat16, read
// as float, and the shared operand S and blocked operand X (S = a and X =
// g for 'out', the roles swapped for 'in'),
//
//     out[b, m] = <S_b S_bᵀ, X_b^m X_b^mᵀ>
//
// where X^m is columns [m w, (m + 1) w) of X, w = width(X) / M: the
// squared Frobenius norm of block m of example b's weight gradient,
// without forming the gradient in device memory. Output (B, M) float.
// Per-shard clipping runs it in the backward of every blocked projection
// (qkv and o of each layer).
//
// Design. The TPU grid (B, M, T/bt, T/bt, k) rebuilt the shared gram
// block S_i S_jᵀ for every block m: at M = 16 on qwen3-4b that is 5x
// `ghost_norm`'s work at the qkv shape and 10x at the o shape. Here S's
// gram is built once. No float atomics: the result is deterministic.
// - bfloat16 runs gram_mma.cuh on the tensor cores: phase 1 builds S's
//   128 x 128 gram tiles over feature chunks and reduces them into a
//   workspace; phase 2 builds each block's X^m gram tiles chunk by chunk
//   (a chunk never crosses a block boundary; TMA's 4-D map over (w, M, T,
//   B) zero-fills a box past the block's end where w is a multiple of 8,
//   plain loads take other widths) and multiplies them into the reduced S
//   tile in registers; phase 3 sums each (b, m)'s partials in order
//   (ghost_norm.py:plan has the chunk counts and the workspace).
// - float32 keeps the CUDA-core loop of gram_tile.cuh: one block per
//   (b, i, j >= i) pair of 32-row tiles builds S_i S_jᵀ once in
//   registers, then loops over the M blocks, building X_i^m X_j^mᵀ and
//   writing one partial per (pair, m), doubled for i < j; a second launch
//   sums each (b, m)'s partials in pair order.
// Rows past T and columns past a block's width load as zero.
//
// Bound. 2 B T (din + dout) bf16 inputs read once against B T² (din +
// dout) operations: T / 4 = 64 operations per byte at T = 256, below the
// H100's bf16 ridge of about 295, so the bytes bound it. The total work
// equals ghost_norm's on the same layer.
#include <cuda_runtime.h>

#include <cstddef>

#include "gram_mma.cuh"
#include "gram_tile.cuh"

namespace {

using gram_tile::kChunk;
using gram_tile::kPad;
using gram_tile::kThreads;
using gram_tile::kTile;

// s: (B, T, ds) shared operand; x: (B, T, dx) blocked operand, M blocks
// of w = dx / M columns; partial: (B, M, npairs).
__global__ void __launch_bounds__(kThreads)
ghost_norm_blocked_pairs(const float* __restrict__ s,
                         const float* __restrict__ x,
                         float* __restrict__ partial, int t_len, int ds,
                         int dx, int num_blocks, int nt, int npairs) {
  __shared__ float xi[kChunk][kPad];
  __shared__ float xj[kChunk][kPad];
  __shared__ float warp_sum[kThreads / 32];
  const int b = blockIdx.x / npairs;
  const int p = blockIdx.x - b * npairs;
  int i, j;
  gram_tile::pair_of(p, nt, &i, &j);
  const float twice = (i == j ? 1.f : 2.f);

  float gs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  gram_tile::gram_block(s + static_cast<size_t>(b) * t_len * ds, t_len, ds,
                        ds, i * kTile, j * kTile, xi, xj, gs);
  const int w = dx / num_blocks;
  const float* xb = x + static_cast<size_t>(b) * t_len * dx;
  for (int m = 0; m < num_blocks; ++m) {
    float gx[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    gram_tile::gram_block(xb + static_cast<size_t>(m) * w, t_len, dx, w,
                          i * kTile, j * kTile, xi, xj, gx);
    const float total =
        gram_tile::block_sum(gram_tile::dot4(gs, gx), warp_sum);
    if (threadIdx.x == 0)
      partial[(static_cast<size_t>(b) * num_blocks + m) * npairs + p] =
          twice * total;
  }
}

int launch_f32(const float* s, const float* x, float* partial, float* out,
               int B, int t_len, int ds, int dx, int num_blocks,
               cudaStream_t stream) {
  const int nt = (t_len + kTile - 1) / kTile;
  const int npairs = nt * (nt + 1) / 2;
  ghost_norm_blocked_pairs<<<B * npairs, kThreads, 0, stream>>>(
      s, x, partial, t_len, ds, dx, num_blocks, nt, npairs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * num_blocks;
  gram_mma::sum_rows<<<(rows + 127) / 128, 128, 0, stream>>>(
      partial, out, rows, npairs);
  return static_cast<int>(cudaGetLastError());
}

long long f32_workspace(int B, int t_len, int num_blocks) {
  const long long nt = (t_len + kTile - 1) / kTile;
  return static_cast<long long>(B) * num_blocks * (nt * (nt + 1) / 2);
}

}  // namespace

extern "C" {

// Floats of workspace a call takes: ghost_norm.py:plan computes the same.
long long ghost_norm_blocked_workspace(int B, int t_len, int ds, int dx,
                                       int num_blocks, int is_bf16) {
  if (!is_bf16) return f32_workspace(B, t_len, num_blocks);
  return gram_mma::make_plan(B, t_len, ds, dx, num_blocks).total();
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// a code past the runtime's (no tensor-map encoder, a refused map, a
// workspace smaller than ghost_norm_blocked_workspace). s: the shared
// operand (B, T, ds); x: the blocked operand (B, T, dx), dx a multiple of
// num_blocks; ws: ws_floats floats of scratch; out: B * num_blocks
// floats. is_bf16: 1 for bfloat16 s and x, 0 for float.
int ghost_norm_blocked_launch(const void* s, const void* x, void* ws,
                              long long ws_floats, void* out, int B,
                              int t_len, int ds, int dx, int num_blocks,
                              int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  if (is_bf16)
    return gram_mma::launch(s, x, w, ws_floats, o, B, t_len, ds, dx,
                            num_blocks, st);
  if (ws_floats < f32_workspace(B, t_len, num_blocks))
    return gram_mma::kErrWorkspace;
  return launch_f32(static_cast<const float*>(s),
                    static_cast<const float*>(x), w, o, B, t_len, ds, dx,
                    num_blocks, st);
}

}  // extern "C"
