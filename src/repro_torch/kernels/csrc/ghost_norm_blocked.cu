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
// without forming the gradient or any (T x T) gram in device memory.
// Output (B, M) float. Per-shard clipping runs it in the backward of every
// blocked projection (qkv and o of each layer).
//
// Design. The TPU grid (B, M, T/bt, T/bt, k) rebuilt the shared gram
// block S_i S_jᵀ for every block m: at M = 16 on qwen3-4b that is 5x
// `ghost_norm`'s work at the qkv shape and 10x at the o shape. Here one
// block owns one (b, i, j >= i) pair of 32-row tiles, as in ghost_norm.cu,
// and builds S_i S_jᵀ ONCE, in registers (`gram_tile.cuh`). It then loops
// over the M column blocks of X: for each it builds X_i^m X_j^mᵀ, reduces
// its inner product with the shared gram block in a fixed order and
// writes one float partial per (pair, m), doubled for i < j (the summand
// is symmetric in (i, j), so the pairs j < i are skipped). A second launch
// sums each (b, m)'s partials in pair order. No float atomics: the result
// is deterministic. Rows past T and columns past a block's width load as
// zero. The total work equals ghost_norm's on the same layer:
// B T² (din + dout) operations with the symmetry.
//
// Bound. 2 B T (din + dout) bf16 inputs read once against B T² (din +
// dout) operations: T / 4 = 64 operations per byte at T = 256, below the
// H100's bf16 ridge of about 295, so on paper the bytes bound it. Like
// ghost_norm.cu, this first version runs CUDA-core f32 FMAs fed from
// shared memory and re-reads rows i and j once per pair, so shared-memory
// bandwidth and L2 bound it instead; a wgmma version comes later.
#include <cuda_runtime.h>

#include <cstddef>

#include "gram_tile.cuh"

namespace {

using gram_tile::kChunk;
using gram_tile::kPad;
using gram_tile::kThreads;
using gram_tile::kTile;

// s: (B, T, ds) shared operand; x: (B, T, dx) blocked operand, M blocks
// of w = dx / M columns; partial: (B, M, npairs).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ghost_norm_blocked_pairs(const T* __restrict__ s, const T* __restrict__ x,
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
  const T* xb = x + static_cast<size_t>(b) * t_len * dx;
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

// out[r] = sum of row r's partials (r = b M + m), in pair order.
__global__ void ghost_norm_blocked_sum(const float* __restrict__ partial,
                                       float* __restrict__ out, int rows,
                                       int npairs) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float acc = 0.f;
  for (int p = 0; p < npairs; ++p)
    acc += partial[static_cast<size_t>(r) * npairs + p];
  out[r] = acc;
}

template <typename T>
int launch(const void* s, const void* x, void* partial, void* out, int B,
           int t_len, int ds, int dx, int num_blocks, cudaStream_t stream) {
  const int nt = (t_len + kTile - 1) / kTile;
  const int npairs = nt * (nt + 1) / 2;
  ghost_norm_blocked_pairs<T><<<B * npairs, kThreads, 0, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(x),
      static_cast<float*>(partial), t_len, ds, dx, num_blocks, nt, npairs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * num_blocks;
  ghost_norm_blocked_sum<<<(rows + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), rows,
      npairs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// s: the shared operand (B, T, ds); x: the blocked operand (B, T, dx),
// dx a multiple of num_blocks; partial: B * num_blocks * (tile pairs of
// T, as ghost_norm_num_pairs) floats of scratch; out: B * num_blocks
// floats. is_bf16: 1 for bfloat16 s and x, 0 for float.
int ghost_norm_blocked_launch(const void* s, const void* x, void* partial,
                              void* out, int B, int t_len, int ds, int dx,
                              int num_blocks, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(s, x, partial, out, B, t_len, ds, dx,
                                 num_blocks, st);
  return launch<float>(s, x, partial, out, B, t_len, ds, dx, num_blocks, st);
}

}  // extern "C"
