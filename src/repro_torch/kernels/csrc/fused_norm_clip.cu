// One linear layer's whole clip in one launch, for Hopper (sm_90a):
// per-example gradient norms², clip factors and the clipped, summed weight
// gradient.
//
// Replaces the TPU kernel `fused_norm_clip` of
// src/repro/kernels/fused_clip.py (`_kernel`, launched by `pl.pallas_call`
// in `fused_norm_clip`). It computes the same function: for a (B, T, din)
// and g (B, T, dout), float or bfloat16, encoded thresholds c (B,) float
// and optional co-grouped norms² extra (B,) float,
//
//     n[b] = ||A_bᵀ G_b||²_F                      (the weight part only)
//     f[b] = clip_factor(c[b], n[b] + extra[b])
//     dw   = sum_b f[b] A_bᵀ G_b                  (float, din x dout)
//
// with clip_factor as in repro_torch/core/ghost.py: min(1, c rsqrt(n +
// 1e-12)) for c > 0, 1 for c = +inf, |c| for c < 0.
//
// Design. The TPU kernel runs grid (b, i, j) in order and carries one
// untiled (din, dout) f32 accumulator across it, so its memory does not
// grow with B. Hopper's blocks run in parallel. But the per-example tile
// A_bᵀ G_b is needed for the clipped sum anyway, and its squared Frobenius
// norm IS the ghost norm: no gram is built, A and G are read once, and each
// example's tile stays in registers until its factor is known.
//
//   One cooperative launch of `grid` = tiles x splits blocks, all
//   co-resident at two a SM (make_plan: shapes and the SM count only, so
//   the order of every sum is fixed). A block owns one 128 (din) x 64 (dout) output tile
//   and one of `splits` contiguous ranges of examples. Each round it runs
//   the mainloop of its next example into a register tile `tmp`, writes
//   the tile's sum of squares (reduced in a fixed order) to a partial
//   slot, and meets every block at a grid barrier. After it, each block
//   sums the example's partials in tile order into n[b], forms f[b] in f32
//   (never rounded to bf16: the sensitivity bound needs it exact) and adds
//   f[b] tmp into its accumulator: acc = fmaf(f, tmp, acc). One example a
//   round: a second tile kept in registers spills at the 128 registers of
//   two blocks a SM (748 bytes, ptxas for sm_90a, CUDA 12.8). After
//   the last round the splits' tiles go to a (splits, din, dout) buffer
//   and, past one more barrier, are summed in split order (with one split
//   the tile goes straight to dw). No atomics but the barrier's: two calls
//   give the same bits.
//   bfloat16 runs contract_mma.cuh's tensor-core mainloop: a ring of 4
//   stages of 64 rows filled by TMA (3-D maps, so rows past T and features
//   past din / dout load as zeros; plain loads where TMA cannot take a
//   row), MN-major operands through wgmma's transpose flags, m64n64k16 per
//   warpgroup. float runs CUDA-core FMAs, 8 x 4 outputs a thread, over
//   32-row chunks copied by cp.async three stages ahead.
//
// Memory. Scratch is the splits' tiles (splits din dout floats; none with
// one split) and two rounds of partials (2 splits tiles floats, the slots
// of round r + 2 reuse round r's once every block has passed round r + 1's
// barrier), whatever B. The barrier is one 64-bit arrival count
// that persists across calls and is never reset (GridBarrier), so a CUDA
// graph replays the launch as it is.
//
// Bound. 2 B T din dout operations against B T (din + dout) input
// elements and a din x dout float output: at granite-moe-3b-a800m's router
// (B = 8, T = 256, bf16, 1536 -> 40) 0.25 GFLOP against 6.7 MB, so the
// bytes bound it (about 2.0 us at 3.35 TB/s). Each round adds a grid
// barrier's latency; the router takes one round (8 splits of 1 example,
// 12 tiles, 96 blocks) and a second barrier before the splits' sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "contract_mma.cuh"
#include "hopper_ptx.cuh"

namespace {

using namespace hopper_ptx;
namespace cm = contract_mma;

constexpr int kBM = 128;        // din rows of an output tile
constexpr int kBN = 64;         // dout columns of an output tile
constexpr int kThreads = 256;   // two warpgroups
constexpr int kOcc = 2;         // co-resident blocks a SM the plan counts on
// the most tiles of one call: kOcc blocks on each of an H100's 132 SMs
constexpr int kMaxTiles = kOcc * 132;
constexpr int kStages = 4;      // ring depth
constexpr int kFrag = 32;       // accumulator floats a thread
constexpr int kRowsBf16 = cm::kKS;  // sequence rows a stage, bfloat16
constexpr int kRowsF32 = 32;        // and float
// a stage: 128 + 64 features of 64 bf16 rows, or of 32 float rows
constexpr int kStageBytes = 3 * cm::kBoxBytes;
static_assert(kStageBytes == (kBM + kBN) * kRowsF32 * 4, "stage sizes");
static_assert(cm::kThreads == kThreads && kBM == cm::kBM, "contract_mma");

constexpr int kErrTooManyTiles = 10003, kErrNotResident = 10004;

struct Shared {
  uint64_t bars[kStages];  // one mbarrier a stage (bfloat16 + TMA)
  float warp[kThreads / 32];
  float part[kMaxTiles];
  float f;
};
// 1024 bytes of alignment slack (the swizzle needs 1024-aligned boxes)
constexpr int kSmem = 1024 + kStages * kStageBytes + sizeof(Shared);

struct Plan {
  int tiles_m, tiles_n, tiles, splits, rounds, rows, chunks, grid;
  long long scratch;  // floats
};

// As kernels/fused_clip.py:plan.
Plan make_plan(int B, int T, int din, int dout, int is_bf16, int sm_count) {
  Plan p;
  p.tiles_m = (din + kBM - 1) / kBM;
  p.tiles_n = (dout + kBN - 1) / kBN;
  p.tiles = p.tiles_m * p.tiles_n;
  int s = kOcc * sm_count / p.tiles;  // a split for every free block
  s = s < 1 ? 1 : (s > B ? B : s);
  p.splits = s;
  p.rounds = (B + s - 1) / s;  // examples of the largest split
  p.rows = is_bf16 ? kRowsBf16 : kRowsF32;
  p.chunks = (T + p.rows - 1) / p.rows;
  p.grid = p.tiles * s;
  p.scratch = (s > 1 ? static_cast<long long>(s) * din * dout : 0) +
              2LL * s * p.tiles;
  return p;
}

bool plan_fits(const Plan& p, int sm_count) {
  return p.tiles <= kMaxTiles && p.tiles <= kOcc * sm_count;
}

struct Params {
  CUtensorMap map_a, map_g;  // bfloat16 by TMA
  const void* a;
  const void* g;
  const float* c;
  const float* extra;  // or null
  float* n_out;
  float* dw;
  float* part;     // (splits, din, dout), splits > 1
  float* partial;  // (2, splits, tiles)
  unsigned long long* bar;  // GridBarrier's arrival count
  int B, T, din, dout;
  int tiles_n, tiles, splits, rounds, chunks;
};

// The encoded-threshold factor, as repro_torch/core/ghost.py:clip_factor
// (a NaN threshold or norm gives NaN, as torch.clamp does).
__device__ __forceinline__ float clip_factor(float c, float n) {
  if (c < 0.f) return -c;  // direct scale
  if (isinf(c)) return 1.f;  // +inf: no clipping
  const float v = c * rsqrtf(n + 1e-12f);
  return v > 1.f ? 1.f : v;
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long add_acq_rel(
    unsigned long long* p, unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.add.acq_rel.gpu.u64 %0, [%1], %2;"
               : "=l"(old)
               : "l"(p), "l"(v)
               : "memory");
  return old;
}

// At most this many arrivals a launch (grid x barriers).
constexpr unsigned long long kEpoch = 1ull << 40;

// The grid barrier over a 64-bit arrival count that persists across
// launches and is never reset: a launch starts at a multiple of kEpoch
// (every block reads it), its barrier k ends when the count reaches
// epoch + (k + 1) gridDim.x, and the last block into its last barrier
// moves the count on to the next multiple. So a CUDA graph replays the
// launch as it is. Thread 0 arrives and waits for the whole block.
struct GridBarrier {
  unsigned long long* count;
  unsigned long long epoch = 0;
  int k = 0;

  __device__ explicit GridBarrier(unsigned long long* c) : count(c) {
    if (threadIdx.x == 0) epoch = ld_acquire(count) / kEpoch * kEpoch;
  }

  __device__ void sync(bool last) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned long long end =
          epoch + static_cast<unsigned long long>(++k) * gridDim.x;
      if (add_acq_rel(count, 1) + 1 == end && last)
        atomicExch(count, epoch + kEpoch);
      else
        while (ld_acquire(count) < end) {
        }
    }
    __syncthreads();
  }
};

// The sum of squares of a block's tile: each thread's fragment in order,
// a warp by a butterfly (every lane gets the same bits), the warps in
// order. Thread 0 returns it.
__device__ __forceinline__ float tile_sumsq(const float (&t)[kFrag],
                                            float* warp_sums) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kFrag; ++i) s = fmaf(t[i], t[i], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = s;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  return total;
}

// bfloat16: the tensor-core mainloop of contract_mma.cuh over the block's
// examples, iteration j = (example b_lo + j / chunks, rows of chunk
// j % chunks), stage j % kStages, refilled kStages iterations ahead. kTma:
// both operands by TMA (each stage completes an mbarrier), else both by
// plain loads (a row TMA cannot take), so neither path holds the other's
// registers.
template <bool kTma>
struct MmaLoop {
  const Params& p;
  uint8_t* smem;
  uint64_t* bars;
  int m0, n0, b_lo, n_it, it = 0;

  __device__ MmaLoop(const Params& prm, uint8_t* s, uint64_t* b, int m,
                     int n, int lo, int iters)
      : p(prm), smem(s), bars(b), m0(m), n0(n), b_lo(lo), n_it(iters) {
    if (kTma && threadIdx.x == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    for (int j = 0; j < kStages && j < n_it; ++j) load(j);
    __syncthreads();
  }

  __device__ void load(int j) {
    const int st = j % kStages;
    const int nb = b_lo + j / p.chunks, t0 = (j % p.chunks) * kRowsBf16;
    uint8_t* sa = smem + st * kStageBytes;
    uint8_t* sg = sa + 2 * cm::kBoxBytes;
    if constexpr (kTma) {
      if (threadIdx.x == 0) {
        const uint32_t bar = smem_u32(&bars[st]);
        mbar_expect_tx(bar, kStageBytes);
        for (int q = 0; q < 2; ++q)
          tma_load(smem_u32(sa + q * cm::kBoxBytes), &p.map_a, bar,
                   m0 + q * cm::kAtom, t0, nb);
        tma_load(smem_u32(sg), &p.map_g, bar, n0, t0, nb);
      }
    } else {
#pragma unroll 1
      for (int q = 0; q < 3; ++q) {
        const bool is_a = q < 2;
        load_box(sa + q * cm::kBoxBytes, is_a ? p.a : p.g,
                 is_a ? p.din : p.dout, is_a ? m0 + q * cm::kAtom : n0, t0,
                 nb);
      }
      // generic writes -> wgmma's proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
  }

  // One 64-feature x 64-row box of x (nb, T, d) by plain 2-byte loads, in
  // TMA's 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)),
  // zeros past T and d: eight rows a thread in flight at a time
  // (contract_mma.cuh's load_boxes holds sixteen, which spills here).
  __device__ void load_box(uint8_t* dst, const void* src, int d, int f0,
                           int t0, int nb) const {
    constexpr int kRowStep = kThreads / cm::kAtom;  // 4
    const int c = threadIdx.x % cm::kAtom, r0 = threadIdx.x / cm::kAtom;
    const int f = f0 + c;
    const unsigned short* s16 = static_cast<const unsigned short*>(src) +
                                (static_cast<size_t>(nb) * p.T + t0) * d + f;
#pragma unroll 1
    for (int h = 0; h < cm::kKS / kRowStep; h += 8) {
      unsigned short v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = r0 + (h + k) * kRowStep;
        v[k] = (t0 + r < p.T && f < d)
                   ? __ldg(s16 + static_cast<size_t>(r) * d)
                   : static_cast<unsigned short>(0);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = r0 + (h + k) * kRowStep;
        *reinterpret_cast<unsigned short*>(
            dst + r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2) = v[k];
      }
    }
  }

  __device__ void issue(float (&d)[kFrag], int j, bool first) {
    const int st = j % kStages;
    if (kTma) mbar_wait(smem_u32(&bars[st]), (j / kStages) & 1);
    const uint32_t sa = smem_u32(smem + st * kStageBytes);
    const uint32_t sg = sa + 2 * cm::kBoxBytes;
    const int wg = threadIdx.x / 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowsBf16 / 16; ++kk)
      cm::wgmma_m64n64(d, cm::desc(sa + wg * cm::kBoxBytes + kk * 2048),
                       cm::desc(sg + kk * 2048), !first || kk > 0);
    wgmma_commit();
  }

  __device__ void refill(int j) {
    if (j + kStages < n_it) load(j + kStages);
  }

  // The next example's A_bᵀ G_b into t: one wgmma group kept in flight
  // across each barrier and refill, as contract_mma.cuh's mainloop.
  __device__ void example(float (&t)[kFrag]) {
    issue(t, it, true);
    for (int c = 1; c < p.chunks; ++c) {
      issue(t, it + c, false);
      wgmma_wait<1>();
      __syncthreads();
      refill(it + c - 1);
    }
    it += p.chunks;
    wgmma_wait<0>();
    fence_regs(t);
    __syncthreads();  // the last chunk's stage is read
    refill(it - 1);
  }

  __device__ void store(const float (&acc)[kFrag], float* out) const {
    cm::store_tile(acc, out, m0, n0, p.din, p.dout);
  }
};

// float: CUDA-core FMAs; a stage holds 32 rows of the tile's 128 a
// features then of its 64 g features, copied by cp.async (4 bytes an
// element), kStages - 1 stages ahead. Thread (ty, tx) = (tid / 16,
// tid % 16) owns rows ty * 4 + {0..3} and 64 + ty * 4 + {0..3}, columns
// tx * 4 + {0..3}: fragment element 4 m + n.
struct SimtLoop {
  const Params& p;
  uint8_t* smem;
  int m0, n0, b_lo, n_it, it = 0;

  __device__ SimtLoop(const Params& prm, uint8_t* s, uint64_t*, int m,
                      int n, int lo, int iters)
      : p(prm), smem(s), m0(m), n0(n), b_lo(lo), n_it(iters) {
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < n_it) load(j);
      cp_async_commit();
    }
  }

  __device__ void load(int j) {
    float* as = reinterpret_cast<float*>(smem + (j % kStages) * kStageBytes);
    float* gs = as + kRowsF32 * kBM;
    const int nb = b_lo + j / p.chunks, t0 = (j % p.chunks) * kRowsF32;
    const float* a = static_cast<const float*>(p.a) +
                     static_cast<size_t>(nb) * p.T * p.din;
    const float* g = static_cast<const float*>(p.g) +
                     static_cast<size_t>(nb) * p.T * p.dout;
    for (int e = threadIdx.x; e < kRowsF32 * kBM; e += kThreads) {
      const int r = t0 + e / kBM, i = m0 + e % kBM;
      if (r < p.T && i < p.din)
        cp_async(smem_u32(as + e), a + static_cast<size_t>(r) * p.din + i,
                 4);
      else
        as[e] = 0.f;
    }
    for (int e = threadIdx.x; e < kRowsF32 * kBN; e += kThreads) {
      const int r = t0 + e / kBN, j2 = n0 + e % kBN;
      if (r < p.T && j2 < p.dout)
        cp_async(smem_u32(gs + e), g + static_cast<size_t>(r) * p.dout + j2,
                 4);
      else
        gs[e] = 0.f;
    }
  }

  __device__ void example(float (&t)[kFrag]) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < kFrag; ++i) t[i] = 0.f;
    for (int c = 0; c < p.chunks; ++c, ++it) {
      cp_async_wait(kStages - 2);  // iteration it's copies are done
      __syncthreads();  // ... everyone's, and iteration it - 1 is read
      if (it + kStages - 1 < n_it) load(it + kStages - 1);
      cp_async_commit();
      const float* as =
          reinterpret_cast<const float*>(smem + (it % kStages) * kStageBytes);
      const float* gs = as + kRowsF32 * kBM;
#pragma unroll 2
      for (int k = 0; k < kRowsF32; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(as + k * kBM +
                                                           ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(as + k * kBM +
                                                           64 + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(gs + k * kBN +
                                                          tx * 4);
        const float x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            t[4 * m + n] = fmaf(x[m], y[n], t[4 * m + n]);
      }
    }
  }

  __device__ void store(const float (&acc)[kFrag], float* out) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int i = m0 + (m < 4 ? ty * 4 + m : 64 + ty * 4 + m - 4);
      if (i >= p.din) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int j = n0 + tx * 4 + n;
        if (j < p.dout) out[static_cast<size_t>(i) * p.dout + j] =
            acc[4 * m + n];
      }
    }
  }
};

template <class Loop>
__global__ void __launch_bounds__(kThreads, kOcc)
fused_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Shared& sh = *reinterpret_cast<Shared*>(smem + kStages * kStageBytes);
  const int tile = blockIdx.x % p.tiles, split = blockIdx.x / p.tiles;
  const int m0 = tile / p.tiles_n * kBM, n0 = tile % p.tiles_n * kBN;
  const int b_lo = static_cast<int>(static_cast<long>(split) * p.B / p.splits);
  const int b_hi =
      static_cast<int>(static_cast<long>(split + 1) * p.B / p.splits);
  Loop loop(p, smem, sh.bars, m0, n0, b_lo, (b_hi - b_lo) * p.chunks);
  GridBarrier barrier(p.bar);

  float acc[kFrag], tmp[kFrag];
#pragma unroll
  for (int i = 0; i < kFrag; ++i) acc[i] = 0.f;

  for (int r = 0; r < p.rounds; ++r) {
    const int b = b_lo + r;  // past b_hi: a shorter split's idle round
    float* slot = p.partial + static_cast<size_t>((r & 1) * p.splits +
                                                  split) * p.tiles;
    if (b < b_hi) {
      loop.example(tmp);
      const float ss = tile_sumsq(tmp, sh.warp);
      if (threadIdx.x == 0) slot[tile] = ss;
    }
    barrier.sync(r == p.rounds - 1 && p.splits == 1);
    if (b >= b_hi) continue;
    // the example's norm: the partials of every tile, summed in tile order
    for (int t = threadIdx.x; t < p.tiles; t += kThreads)
      sh.part[t] = __ldcg(slot + t);
    __syncthreads();
    if (threadIdx.x == 0) {
      float n = 0.f;
      for (int t = 0; t < p.tiles; ++t) n += sh.part[t];
      sh.f = clip_factor(p.c[b], p.extra != nullptr ? n + p.extra[b] : n);
      if (tile == 0) p.n_out[b] = n;
    }
    __syncthreads();
    const float f = sh.f;
#pragma unroll
    for (int i = 0; i < kFrag; ++i) acc[i] = fmaf(f, tmp[i], acc[i]);
  }

  if (p.splits == 1) {
    loop.store(acc, p.dw);
    return;
  }
  const size_t total = static_cast<size_t>(p.din) * p.dout;
  loop.store(acc, p.part + split * total);
  barrier.sync(true);
  // dw = the splits' tiles summed in split order, over the whole grid;
  // eight splits' loads in flight before their adds
  const size_t step = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t first = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (total % 4 == 0) {
    const float4* part = reinterpret_cast<const float4*>(p.part);
    float4* dw = reinterpret_cast<float4*>(p.dw);
    const size_t n4 = total / 4;
    for (size_t e = first; e < n4; e += step) {
      float4 v = __ldcg(part + e);
      for (int q0 = 1; q0 < p.splits; q0 += 8) {
        float4 w[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (q0 + u < p.splits) w[u] = __ldcg(part + (q0 + u) * n4 + e);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (q0 + u < p.splits) {
            v.x += w[u].x;
            v.y += w[u].y;
            v.z += w[u].z;
            v.w += w[u].w;
          }
      }
      dw[e] = v;
    }
  } else {
    for (size_t e = first; e < total; e += step) {
      float v = __ldcg(p.part + e);
      for (int q0 = 1; q0 < p.splits; q0 += 8) {
        float w[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (q0 + u < p.splits) w[u] = __ldcg(p.part + (q0 + u) * total + e);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (q0 + u < p.splits) v += w[u];
      }
      p.dw[e] = v;
    }
  }
}

template <class Loop>
int launch_kernel(const Params& p, int grid, cudaStream_t stream) {
  const auto kern = fused_kernel<Loop>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, kSmem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm * sms < grid) return kErrNotResident;
  // cooperative: a grid that cannot be co-resident is refused, never hung
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The plan of a call (kernels/fused_clip.py:plan) into out[9]: tiles_m,
// tiles_n, tiles, splits, rounds, rows, chunks, grid, scratch floats.
// Returns 1 where the plan fits the card (every block co-resident at
// two a SM), else 0.
int fused_norm_clip_plan(int B, int T, int din, int dout, int is_bf16,
                         int sm_count, long long* out) {
  const Plan p = make_plan(B, T, din, dout, is_bf16, sm_count);
  const long long v[9] = {p.tiles_m, p.tiles_n, p.tiles,
                          p.splits,  p.rounds,  p.rows,
                          p.chunks,  p.grid,    p.scratch};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return plan_fits(p, sm_count) ? 1 : 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success),
// hopper_ptx's codes for a refused tensor map, 10003 for a plan that does
// not fit the card, 10004 for a grid that cannot be co-resident. c: B
// floats; extra: B floats or null; scratch: the plan's scratch floats;
// bar: one 64-bit count, zero before the first call, which every call
// leaves at a multiple of 2^40 (GridBarrier); n: B floats; dw: din * dout floats. is_bf16: 1 for bfloat16
// a and g (tensor cores), 0 for float. sm_count: the plan's SM count.
int fused_norm_clip_launch(const void* a, const void* g, const void* c,
                           const void* extra, void* scratch, void* bar,
                           void* n, void* dw, int B, int t_len, int din,
                           int dout, int is_bf16, int sm_count,
                           void* stream) {
  const Plan pl = make_plan(B, t_len, din, dout, is_bf16, sm_count);
  if (!plan_fits(pl, sm_count)) return kErrTooManyTiles;
  Params p = {};
  p.a = a;
  p.g = g;
  p.c = static_cast<const float*>(c);
  p.extra = static_cast<const float*>(extra);
  p.n_out = static_cast<float*>(n);
  p.dw = static_cast<float*>(dw);
  float* s = static_cast<float*>(scratch);
  const size_t tiles_floats =
      pl.splits > 1 ? static_cast<size_t>(pl.splits) * din * dout : 0;
  p.part = s;
  p.partial = s + tiles_floats;
  p.bar = static_cast<unsigned long long*>(bar);
  p.B = B;
  p.T = t_len;
  p.din = din;
  p.dout = dout;
  p.tiles_n = pl.tiles_n;
  p.tiles = pl.tiles;
  p.splits = pl.splits;
  p.rounds = pl.rounds;
  p.chunks = pl.chunks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch_kernel<SimtLoop>(p, pl.grid, st);
  if (!cm::tma_ok(a, din) || !cm::tma_ok(g, dout))
    return launch_kernel<MmaLoop<false>>(p, pl.grid, st);
  if (encode_tiled() == nullptr) return kErrNoEncoder;
  if (!cm::make_map(&p.map_a, a, din, t_len, B) ||
      !cm::make_map(&p.map_g, g, dout, t_len, B))
    return kErrMap;
  return launch_kernel<MmaLoop<true>>(p, pl.grid, st);
}

}  // extern "C"
