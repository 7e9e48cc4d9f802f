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
// without forming the (din x dout) gradient in device memory. Output (B,)
// float.
//
// Design. The TPU ran grid (b, i, j, k) in order and added each tile
// pair's contribution into out[b] across grid steps. Hopper blocks run in
// parallel and in no order, so the sum over features is split across
// blocks and reduced in fixed order by later launches (no atomics: the
// result is deterministic).
// The caller passes the narrower of a and g first, as the shared operand
// S, and the wider as X (the norm is symmetric in the two).
// - bfloat16 runs gram_mma.cuh on the tensor cores, as the case M = 1 of
//   ghost_norm_blocked: S's 128 x 128 gram tiles are built over feature
//   chunks and reduced
//   into a workspace (phase 1); X streams through phase 2,
//   each chunk's gram tile multiplied into the reduced S tile in
//   registers; phase 3 sums the partials. The workspace holds B x 3 S
//   tiles and the chunk partials at T = 256 (ghost_norm.py:plan).
// - float32 keeps the CUDA-core loop of gram_tile.cuh: one block per
//   (b, i, j >= i) pair of 32-row tiles builds S_i S_jᵀ and X_i X_jᵀ over
//   all features in registers, reduces their inner product and writes one
//   partial, doubled for i < j; a second launch sums each example's
//   partials in pair order.
// Rows past T and features past d load as zeros (the TPU padded them), so
// ragged T and narrow layers need no padding.
//
// Bound. With the symmetry, B T² (din + dout) operations against
// 2 B T (din + dout) bf16 inputs read once: T / 4 = 64 operations per byte
// on the training path (B = 8, T = 256), below the H100's bf16 ridge of
// about 295, so the bytes bound it. The tensor-core path reads each
// example's rows twice through L2 (3 tiles over 2 row blocks) and does
// 3/2 of the symmetric operations (whole 128 x 128 diagonal tiles).
#include <cuda_runtime.h>

#include <cstddef>

#include "gram_mma.cuh"
#include "gram_tile.cuh"

namespace {

using gram_tile::kChunk;
using gram_tile::kPad;
using gram_tile::kThreads;
using gram_tile::kTile;

__global__ void __launch_bounds__(kThreads)
ghost_norm_pairs(const float* __restrict__ s, const float* __restrict__ x,
                 float* __restrict__ partial, int t_len, int ds, int dx,
                 int nt, int npairs) {
  __shared__ float xi[kChunk][kPad];
  __shared__ float xj[kChunk][kPad];
  __shared__ float warp_sum[kThreads / 32];
  const int b = blockIdx.x / npairs;
  int i, j;
  gram_tile::pair_of(blockIdx.x - b * npairs, nt, &i, &j);

  float gs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float gx[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  gram_tile::gram_block(s + static_cast<size_t>(b) * t_len * ds, t_len, ds,
                        ds, i * kTile, j * kTile, xi, xj, gs);
  gram_tile::gram_block(x + static_cast<size_t>(b) * t_len * dx, t_len, dx,
                        dx, i * kTile, j * kTile, xi, xj, gx);
  const float total = gram_tile::block_sum(gram_tile::dot4(gs, gx), warp_sum);
  if (threadIdx.x == 0) partial[blockIdx.x] = (i == j ? 1.f : 2.f) * total;
}

int launch_f32(const float* s, const float* x, float* partial, float* out,
               int B, int t_len, int ds, int dx, cudaStream_t stream) {
  const int nt = (t_len + kTile - 1) / kTile;
  const int npairs = nt * (nt + 1) / 2;
  ghost_norm_pairs<<<B * npairs, kThreads, 0, stream>>>(
      s, x, partial, t_len, ds, dx, nt, npairs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_mma::sum_rows<<<(B + 127) / 128, 128, 0, stream>>>(partial, out, B,
                                                          npairs);
  return static_cast<int>(cudaGetLastError());
}

long long f32_workspace(int B, int t_len) {
  const long long nt = (t_len + kTile - 1) / kTile;
  return B * (nt * (nt + 1) / 2);
}

}  // namespace

extern "C" {

// Floats of workspace a call takes: ghost_norm.py:plan computes the same.
long long ghost_norm_workspace(int B, int t_len, int ds, int dx,
                               int is_bf16) {
  if (!is_bf16) return f32_workspace(B, t_len);
  return gram_mma::make_plan(B, t_len, ds, dx, 1).total();
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// a code past the runtime's (no tensor-map encoder, a refused map, a
// workspace smaller than ghost_norm_workspace). s (B, T, ds): the shared
// operand, the narrower of a and g; x (B, T, dx): the other; ws:
// ws_floats floats of scratch; out: B floats. is_bf16: 1 for bfloat16 s
// and x, 0 for float.
int ghost_norm_launch(const void* s, const void* x, void* ws,
                      long long ws_floats, void* out, int B, int t_len,
                      int ds, int dx, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  if (is_bf16)
    return gram_mma::launch(s, x, w, ws_floats, o, B, t_len, ds, dx, 1, st);
  if (ws_floats < f32_workspace(B, t_len)) return gram_mma::kErrWorkspace;
  return launch_f32(static_cast<const float*>(s),
                    static_cast<const float*>(x), w, o, B, t_len, ds, dx, st);
}

}  // extern "C"
