// One linear layer's whole clip, for Hopper (sm_90a): per-example gradient
// norms², clip factors and the clipped, summed weight gradient.
//
// Replaces the TPU kernel `fused_norm_clip` of
// src/repro/kernels/fused_clip.py (`_kernel`, launched by `pl.pallas_call`
// in `fused_norm_clip`). It computes the same function: for a (B, T, din)
// and g (B, T, dout), float or bfloat16, read as float, encoded thresholds
// c (B,) float and optional co-grouped norms² extra (B,) float,
//
//     n[b] = ||A_bᵀ G_b||²_F                      (the weight part only)
//     f[b] = clip_factor(c[b], n[b] + extra[b])
//     dw   = sum_b f[b] A_bᵀ G_b                  (float, din x dout)
//
// with clip_factor as in repro_torch/core/ghost.py: min(1, c rsqrt(n +
// 1e-12)) for c > 0, 1 for c = +inf, |c| for c < 0.
//
// Design. The TPU ran grid (b, i, j) in order: both (T x T) grams for the
// norm, the per-example gradient of each diagonal step accumulated in an
// untiled (din, dout) VMEM buffer, and f[b] applied once b's last step had
// completed its norm. Hopper blocks run in parallel and carry nothing from
// one to the next. But the per-example tile A_bᵀ G_b is needed for the
// clipped sum anyway, and its squared Frobenius norm IS the ghost norm, so
// no gram is built and A and G are read once:
//
//   launch 1, grid (dout tiles, din tiles, B): a block loops over the T
//     rows of example b, staging 32-row chunks of A and G in shared memory
//     as float, and accumulates its 64 x 64 tile of A_bᵀ G_b in registers
//     (4 x 4 per thread). It writes the tile to a (B, din, dout) float
//     workspace and the tile's sum of squares, reduced in a fixed order, to
//     partial[b, tile].
//   launch 2: every block sums each example's partials in tile order into
//     n[b], forms f[b] in shared memory, then writes dw = sum_b f[b]
//     work[b] in b order over a grid-stride range of elements; block 0
//     writes n.
//
// No atomics: the result is deterministic. Rows past T and features past
// din / dout load as zero, so ragged T and narrow layers need no padding.
//
// Bound. 2 B T din dout operations against B T (din + dout) input
// elements and a din x dout float output. At the router of
// granite-moe-3b-a800m (B = 8, T = 256, bf16, 1536 -> 40) that is 0.25
// GFLOP against 6.7 MB: the bytes bound it (about 2.0 us at 3.35 TB/s).
// This first version adds the workspace's B din dout floats, written once
// and read once, and runs CUDA-core f32 FMAs; with dout = 40 a 64-column
// tile is 62% full. A single cooperative launch that keeps the B tiles in
// shared memory, and bf16 wgmma, come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBI = 64;  // din rows of a tile
constexpr int kBJ = 64;  // dout columns of a tile
constexpr int kBR = 32;  // sequence rows staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kReduceThreads = 256;
static_assert(kBI == 64 && kBJ == 64 && kThreads == 256,
              "thread map assumes 16x16 threads of 4x4 outputs");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The encoded-threshold factor, as repro_torch/core/ghost.py:clip_factor
// (a NaN threshold or norm gives NaN, as torch.clamp does).
__device__ __forceinline__ float clip_factor(float c, float n) {
  if (c < 0.f) return -c;  // direct scale
  if (isinf(c)) return 1.f;  // +inf: no clipping
  const float v = c * rsqrtf(n + 1e-12f);
  return v > 1.f ? 1.f : v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_tiles(const T* __restrict__ a, const T* __restrict__ g,
            float* __restrict__ work, float* __restrict__ partial, int t_len,
            int din, int dout, int ntiles) {
  __shared__ __align__(16) float as[kBR][kBI];
  __shared__ __align__(16) float gs[kBR][kBJ];
  __shared__ float warp_sum[kThreads / 32];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kBI, j0 = blockIdx.x * kBJ;
  const T* ab = a + static_cast<size_t>(b) * t_len * din;
  const T* gb = g + static_cast<size_t>(b) * t_len * dout;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;

  for (int r0 = 0; r0 < t_len; r0 += kBR) {
    for (int e = tid; e < kBR * kBI; e += kThreads) {
      const int rr = e / kBI, ii = e - rr * kBI, r = r0 + rr, i = i0 + ii;
      as[rr][ii] = (r < t_len && i < din)
                       ? to_f32(ab[static_cast<size_t>(r) * din + i])
                       : 0.f;
    }
    for (int e = tid; e < kBR * kBJ; e += kThreads) {
      const int rr = e / kBJ, jj = e - rr * kBJ, r = r0 + rr, j = j0 + jj;
      gs[rr][jj] = (r < t_len && j < dout)
                       ? to_f32(gb[static_cast<size_t>(r) * dout + j])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBR; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&gs[k][tx * 4]);
      const float x[4] = {av.x, av.y, av.z, av.w};
      const float y[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(x[m], y[n], acc[m][n]);
    }
    __syncthreads();
  }

  // the tile into the workspace; outputs past din / dout are zero and
  // are neither stored nor counted
  float ss = 0.f;
  float* wb = work + static_cast<size_t>(b) * din * dout;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + ty * 4 + m;
    if (i >= din) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = j0 + tx * 4 + n;
      if (j >= dout) continue;
      wb[static_cast<size_t>(i) * dout + j] = acc[m][n];
      ss = fmaf(acc[m][n], acc[m][n], ss);
    }
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tid % 32 == 0) warp_sum[tid / 32] = ss;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    partial[static_cast<size_t>(b) * ntiles + blockIdx.y * gridDim.x +
            blockIdx.x] = total;
  }
}

// n[b] from b's partials in tile order, f[b] in shared memory, then dw over
// a grid-stride range of the din * dout elements, summed in b order.
__global__ void __launch_bounds__(kReduceThreads)
fused_reduce(const float* __restrict__ work, const float* __restrict__ partial,
             const float* __restrict__ c, const float* __restrict__ extra,
             float* __restrict__ n_out, float* __restrict__ dw, int B,
             int ntiles, size_t nelem) {
  extern __shared__ float f[];  // B factors
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    float n = 0.f;
    for (int p = 0; p < ntiles; ++p)
      n += partial[static_cast<size_t>(b) * ntiles + p];
    if (blockIdx.x == 0) n_out[b] = n;
    f[b] = clip_factor(c[b], extra != nullptr ? n + extra[b] : n);
  }
  __syncthreads();
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t k = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < nelem; k += stride) {
    float s = 0.f;
    for (int b = 0; b < B; ++b) s = fmaf(f[b], work[b * nelem + k], s);
    dw[k] = s;
  }
}

template <typename T>
int launch(const void* a, const void* g, const float* c, const float* extra,
           float* work, float* partial, float* n, float* dw, int B,
           int t_len, int din, int dout, cudaStream_t stream) {
  const dim3 grid((dout + kBJ - 1) / kBJ, (din + kBI - 1) / kBI, B);
  const int ntiles = static_cast<int>(grid.x * grid.y);
  fused_tiles<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(g), work, partial,
      t_len, din, dout, ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t nelem = static_cast<size_t>(din) * dout;
  // 4 elements a thread, at most 2 blocks per SM of the 132: each block
  // re-sums the B x ntiles partials
  size_t blocks = (nelem + 4 * kReduceThreads - 1) / (4 * kReduceThreads);
  if (blocks > 264) blocks = 264;
  fused_reduce<<<static_cast<unsigned>(blocks), kReduceThreads,
                 B * sizeof(float), stream>>>(work, partial, c, extra, n, dw,
                                              B, ntiles, nelem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// c: B floats; extra: B floats or null; work: B * din * dout floats and
// partial: B * ceil(din / 64) * ceil(dout / 64) floats of scratch; n: B
// floats; dw: din * dout floats. is_bf16: 1 for bfloat16 a and g, 0 for
// float.
int fused_norm_clip_launch(const void* a, const void* g, const void* c,
                           const void* extra, void* work, void* partial,
                           void* n, void* dw, int B, int t_len, int din,
                           int dout, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(c);
  const float* ef = static_cast<const float*>(extra);
  float* w = static_cast<float*>(work);
  float* p = static_cast<float*>(partial);
  float* nf = static_cast<float*>(n);
  float* d = static_cast<float*>(dw);
  if (is_bf16)
    return launch<__nv_bfloat16>(a, g, cf, ef, w, p, nf, d, B, t_len, din,
                                 dout, s);
  return launch<float>(a, g, cf, ef, w, p, nf, d, B, t_len, din, dout, s);
}

}  // extern "C"
