// Per-example gradient norms² of a linear layer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ghost_norm` of src/repro/kernels/ghost_norm.py
// (`_kernel`, launched by `pl.pallas_call` in `ghost_norm`). It computes
// the same function: for a (B, T, din) and g (B, T, dout), float or
// bfloat16, read as float,
//
//     out[b] = <A_b A_bᵀ, G_b G_bᵀ> = sum_{t,t'} <a_t, a_t'> <g_t, g_t'>
//
// the squared Frobenius norm of example b's weight gradient A_bᵀ G_b,
// without forming the (din x dout) gradient or the (T x T) grams in device
// memory. Output (B,) float.
//
// Design. The TPU ran grid (b, i, j, k) in order and added each tile
// pair's contribution into out[b] across grid steps. Hopper blocks run in
// parallel and in no order, so here one block owns one (b, i, j >= i)
// pair of 32-row tiles. It loops over all din features of A, staging 32 x
// 32 chunks of rows i and j in shared memory, to build the (32 x 32) gram
// block A_i A_jᵀ in registers, then over all dout features of G for
// G_i G_jᵀ (`gram_tile.cuh`, shared with ghost_norm_blocked.cu); the
// feature loop cannot be split across blocks, because the
// elementwise product comes after the sum over features. The block then
// reduces <A_i A_jᵀ, G_i G_jᵀ> in a fixed order and writes one float
// partial, doubled for i < j (the summand is symmetric in (i, j), so the
// pairs j < i are skipped). A second launch sums each example's partials
// in pair order. No float atomics: the result is deterministic. Rows past
// T and features past d are loaded as zero (the TPU padded them with
// zeros), so ragged T and narrow layers need no padding.
//
// Bound. With the symmetry, B T² (din + dout) operations against
// 2 B T (din + dout) bf16 inputs read once: T / 4 = 64 operations per byte
// on the training path (B = 8, T = 256), below the H100's bf16 ridge of
// about 295, so on paper the bytes bound it. This first version runs
// CUDA-core f32 FMAs fed from shared memory (4 loads per 4 FMAs per
// thread) and re-reads rows i and j once per pair, so shared-memory
// bandwidth and L2 bound it instead. 32-row tiles give B x 36 = 288 blocks
// at T = 256, more than two per SM. A wgmma version (bf16 products, f32
// accumulation) comes later.
#include <cuda_runtime.h>

#include <cstddef>

#include "gram_tile.cuh"

namespace {

using gram_tile::kChunk;
using gram_tile::kPad;
using gram_tile::kThreads;
using gram_tile::kTile;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ghost_norm_pairs(const T* __restrict__ a, const T* __restrict__ g,
                 float* __restrict__ partial, int t_len, int din, int dout,
                 int nt, int npairs) {
  __shared__ float xi[kChunk][kPad];
  __shared__ float xj[kChunk][kPad];
  __shared__ float warp_sum[kThreads / 32];
  const int b = blockIdx.x / npairs;
  int i, j;
  gram_tile::pair_of(blockIdx.x - b * npairs, nt, &i, &j);

  float ga[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float gg[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  gram_tile::gram_block(a + static_cast<size_t>(b) * t_len * din, t_len, din,
                        din, i * kTile, j * kTile, xi, xj, ga);
  gram_tile::gram_block(g + static_cast<size_t>(b) * t_len * dout, t_len,
                        dout, dout, i * kTile, j * kTile, xi, xj, gg);
  const float total = gram_tile::block_sum(gram_tile::dot4(ga, gg), warp_sum);
  if (threadIdx.x == 0) partial[blockIdx.x] = (i == j ? 1.f : 2.f) * total;
}

// out[b] = sum of example b's partials, in pair order.
__global__ void ghost_norm_sum(const float* __restrict__ partial,
                               float* __restrict__ out, int B, int npairs) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float s = 0.f;
  for (int p = 0; p < npairs; ++p) s += partial[static_cast<size_t>(b) * npairs + p];
  out[b] = s;
}

template <typename T>
int launch(const void* a, const void* g, void* partial, void* out, int B,
           int t_len, int din, int dout, cudaStream_t stream) {
  const int nt = (t_len + kTile - 1) / kTile;
  const int npairs = nt * (nt + 1) / 2;
  ghost_norm_pairs<T><<<B * npairs, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(g),
      static_cast<float*>(partial), t_len, din, dout, nt, npairs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ghost_norm_sum<<<(B + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), B, npairs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tile pairs per example: ghost_norm.py:num_pairs repeats it to size the
// partials buffer.
int ghost_norm_num_pairs(int t_len) {
  const int nt = (t_len + kTile - 1) / kTile;
  return nt * (nt + 1) / 2;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// partial: B * ghost_norm_num_pairs(T) floats of scratch; out: B floats.
// is_bf16: 1 for bfloat16 a and g, 0 for float.
int ghost_norm_launch(const void* a, const void* g, void* partial, void* out,
                      int B, int t_len, int din, int dout, int is_bf16,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(a, g, partial, out, B, t_len, din, dout, s);
  return launch<float>(a, g, partial, out, B, t_len, din, dout, s);
}

}  // extern "C"
