// Paged-gather one-token GQA / MLA decode attention for Hopper (sm_90a),
// split over the context (flash-decoding).
//
// Replaces the TPU kernel `paged_attn` of src/repro/kernels/paged_attn.py
// (`_paged_attn_kernel`, launched by `pl.pallas_call` in `paged_attn`).
// It computes the same function: q (B, KV, G, dq) attends, through the
// int32 page table pt (B, P), to the cache rows of kpool (N, L, KV, dq)
// and vpool (N, L, KV, dvp) whose logical index p*L + i is <= pos[b], with
// the value read truncated to dv <= dvp. Output (B, KV, G, dv) float32.
//
// Bound. GQA decode does about G operations per byte of K/V read, far
// below the ~295 where the tensor cores would matter, so the main path
// (qwen3-4b: G = 4, d = 128, bf16) is bound by the bytes of the valid rows
// and, at a few MB a call, by the latency of fetching them. MLA's latent
// decode (KV = 1, G = 128, dq = 576, dv = 512, f32 q over a bf16 pool)
// does ~2 * 128 * 1088 operations per 1,152-byte row and is bound by the
// f32 rate of the CUDA cores.
//
// Design. The TPU walked the pages of one row in order, carrying the
// online-softmax state in VMEM. Here the grid is (context split, head
// group, b * KV + kv-head): every block owns rows_per_split consecutive
// logical rows (a multiple of L, from paged_attn.py:plan, by shapes only)
// and up to 4 * HW heads of one KV head (HW = 1, or 2 where G > 4), so
// the main path fills the card and MLA's 128 heads go 8 to a block.
//  - Staging: the block reads pos[b] and, through the table, the pool row
//    of each row of its split together, into shared memory (the host
//    reads neither, so a call can be captured in a CUDA graph). 16-row
//    tiles of K (and V, unless the pool is aliased) then go through a
//    ring of `stages` tiles in shared memory by cp.async: a warp copies
//    whole rows, its lanes 16-byte chunks (8 / 4 where a row or the
//    pool's base is not 16-byte aligned, plain 2-byte loads for odd bf16
//    widths), the next tiles in flight while this one is used. The pool's
//    type stays in shared memory; it is widened to f32 in registers. One
//    barrier per tile.
//  - Compute on the CUDA cores in f32. Each warp owns HW heads, holds
//    their q (scaled, rounded to q's type) in registers, and scores 16
//    rows at a time: lanes hold interleaved 4-byte words of a row, every
//    K word is used by all HW heads, and one reduce-scatter of shuffles
//    leaves each row's dot product in two lanes. The online softmax (m,
//    l) and the (HW x dv) accumulator stay in registers (each lane sums l
//    for its own row slot; the lanes are added once, at the end); a warp's
//    probabilities pass through its own slice of shared memory to the
//    P.V loop, where lanes own value columns.
//  - A split writes its (acc, m, l) partial to an f32 workspace (B, KV,
//    G, splits, dv + 2); a split past pos[b] writes an empty one (acc 0,
//    m = -inf, l = 0). `paged_attn_combine`, a block per (b, kv, g), then
//    reads the splits in index order: out = sum_s e_s acc_s / max(sum_s
//    e_s l_s, 1e-30), e_s = exp(m_s - max m). No atomics: two calls give
//    the same bits.
//
// Latency, not bandwidth, sets the main path's time: a block walks its
// tiles in order, so the plan keeps splits short (64 rows, 5 splits at
// qwen3-4b's 272-token table) and the code between two tiles small (the
// copies are one 16-byte cp.async a lane a row, the P.V loop has no branch
// per row, so its loads are all in flight).
//
// Inputs: q float or bfloat16; kpool and vpool one type, float or
// bfloat16, possibly one tensor (then a staged row is both key and value:
// its first dv features are the value); any G; dq <= 576, dv <= 512.
// Every page id in pt must lie in [0, N); the wrapper in paged_attn.py
// checks everything that can be checked without reading device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper_ptx.cuh"

namespace {

using hopper_ptx::cp_async;
using hopper_ptx::cp_async_commit;
using hopper_ptx::cp_async_wait;
using hopper_ptx::smem_u32;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;  // cache rows per stage of the ring
constexpr int kMaxStages = 8;
constexpr int kMaxDevices = 64;
constexpr float kInf = __builtin_huge_valf();

// elements of the pool's type in one 4-byte word, and their f32 values
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int n = 1;
  __device__ static void unpack(uint32_t w, float (&x)[1]) {
    x[0] = __uint_as_float(w);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int n = 2;
  __device__ static void unpack(uint32_t w, float (&x)[2]) {
    x[0] = __uint_as_float(w << 16);
    x[1] = __uint_as_float(w & 0xffff0000u);
  }
};

constexpr int kRows = 16;  // rows a warp scores at once
static_assert(kTile % kRows == 0, "a tile is whole steps of scored rows");

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }
// bytes of the warps' probability slices, then of the split's pool-row
// indices; the ring follows
__host__ __device__ inline int p_bytes(int hw) {
  return 4 * kWarps * kRows * hw;
}
__host__ __device__ inline int row_bytes(int rows) {
  return round16(4 * rows);
}
__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// One halving exchange at lane offset OFF: the lower lanes keep v[0, HALF)
// and add their partner's, the upper lanes keep v[HALF, 2 HALF) into v[0,
// HALF); then the next at OFF / 2. Recursion keeps every index constant,
// so v stays in registers.
template <int N, int HALF, int OFF>
__device__ __forceinline__ void halve(float (&v)[N], int lane) {
  const bool up = lane & OFF;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = up ? v[k] : v[k + HALF];
    const float keep = up ? v[k + HALF] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
  if constexpr (HALF > 1) halve<N, HALF / 2, OFF / 2>(v, lane);
}

// After the call every lane holds the sum over the warp of v[lane / (32 /
// N)]: log2(N) halving exchanges (offsets 16, 8, ...), then the lanes that
// share a row add (the remaining offsets down to 1).
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
  halve<N, N / 2, 16>(v, lane);
  float x = v[0];
#pragma unroll
  for (int step = ilog2(N); step < 5; ++step)
    x += __shfl_xor_sync(0xffffffffu, x, 16 >> step);
  return x;
}

struct Args {
  const void* q;
  const void* kpool;
  const void* vpool;
  const int* pt;
  const int* pos;
  float* ws;
  float* out;
  int B, KV, G, dq, dv, dvp, L, P;
  float scale;
  int q_bf16, alias, vec, rows, splits, gh, stages, smem;
};

// Stages the valid rows [r0, r1) of a split, tile t into ring stage `st`.
// A warp copies rows warp, warp + 4, ... of the tile (their pool-row
// indices from shared memory), its lanes neighbouring `vec`-byte chunks of
// each row's K and then V. The code stays small: it runs once a tile
// beside the scoring loop and must not push it out of the instruction
// cache. One commit group per call, empty past the last tile, so the wait
// count stays uniform.
struct Stager {
  uint32_t ring;         // shared-memory address of the ring
  const uint32_t* rows;  // pool row of each row of the split
  const unsigned char* kbase;
  const unsigned char* vbase;
  size_t krow, vrow;  // bytes between pool rows
  int stage_bytes, kstride, vstride, kch, vch, vec;
  int r0, r1, ntiles, warp, lane;

  __device__ __forceinline__ void issue(int t, int st) const {
    if (t < ntiles) {
      const uint32_t kt = ring + st * stage_bytes;
      const uint32_t vt = kt + kTile * kstride;
      const int i0 = t * kTile;
      const int nr = min(kTile, r1 - r0 - i0);
      constexpr int kRowsPerWarp = kTile / kWarps;
      if (kch + vch <= 32) {
        // a chunk a lane a row (the main path): the rows' addresses
        // first, then the copies back to back
        const int c = lane;
        const bool key = c < kch;
        const int cc = (key ? c : c - kch) * vec;
        uint32_t row[kRowsPerWarp];
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k)
          row[k] = warp + kWarps * k < nr ? rows[i0 + warp + kWarps * k] : 0;
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k) {
          const int r = warp + kWarps * k;
          if (r < nr && c < kch + vch)
            cp_async((key ? kt + r * kstride : vt + r * vstride) + cc,
                     (key ? kbase + row[k] * krow : vbase + row[k] * vrow) +
                         cc,
                     vec);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k) {
          const int r = warp + kWarps * k;
          if (r < nr) {
            const uint32_t row = rows[i0 + r];
#pragma unroll 1
            for (int c = lane; c < kch + vch; c += 32) {
              const bool key = c < kch;
              const int cc = (key ? c : c - kch) * vec;
              cp_async((key ? kt + r * kstride : vt + r * vstride) + cc,
                       (key ? kbase + row * krow : vbase + row * vrow) + cc,
                       vec);
            }
          }
        }
      }
    }
    cp_async_commit();
  }
};

// One (context split, head group, b * KV + h) block; see the file note.
// DL / VL: q / value elements a lane holds (dq <= 32 DL, dv <= 32 VL).
template <typename T, int HW, int DL, int VL>
__global__ void __launch_bounds__(kThreads)
    paged_attn_split(const Args a) {
  constexpr int kPack = Pack<T>::n;
  constexpr int QW = DL / kPack, VW = VL / kPack;  // words per lane
  constexpr int RS = kRows;
  constexpr int kGroup = 32 / RS;  // lanes holding one scored row
  // rows of P.V unrolled at once: all of them at the narrow widths, where
  // the loads' latency dominates; two at MLA's, where registers do
  constexpr int kPvUnroll = VW >= 8 ? 2 : RS;
  static_assert(DL % kPack == 0 && VL % kPack == 0, "whole words");
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem);  // [warp][RS][HW]
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem + p_bytes(HW));
  unsigned char* ring = smem + p_bytes(HW) + row_bytes(a.rows);

  const int s = blockIdx.x, grp = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.KV, h = bh - b * a.KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g_hi = min(grp * a.gh + a.gh, a.G);
  const int g0 = grp * a.gh + warp * HW;  // the warp's first head
  const int nh = max(0, min(HW, g_hi - g0));     // and how many it has
  const int S = a.splits, dv = a.dv;

  // q * scale rounded to q's type, then f32; lane words lane + 32 i
  float qr[HW][DL];
#pragma unroll
  for (int hh = 0; hh < HW; ++hh)
#pragma unroll
    for (int i = 0; i < QW; ++i)
#pragma unroll
      for (int e = 0; e < kPack; ++e) {
        const int d = (lane + 32 * i) * kPack + e;
        float x = 0.f;
        if (hh < nh && d < a.dq) {
          const size_t idx =
              (static_cast<size_t>(bh) * a.G + g0 + hh) * a.dq + d;
          if (a.q_bf16) {
            const float y =
                __bfloat162float(
                    static_cast<const __nv_bfloat16*>(a.q)[idx]) * a.scale;
            x = __bfloat162float(__float2bfloat16(y));
          } else {
            x = static_cast<const float*>(a.q)[idx] * a.scale;
          }
        }
        qr[hh][i * kPack + e] = x;
      }

  // pos[b], and the pool row of every row of the split (by shape), in
  // flight together
  const int r0 = s * a.rows;
  const int pos_b = __ldg(a.pos + b);
  const int* ptb = a.pt + static_cast<size_t>(b) * a.P;
  for (int i = tid; i < min(a.rows, a.P * a.L - r0); i += kThreads) {
    const int j = r0 + i, p = j / a.L;
    rows[i] = (static_cast<uint32_t>(__ldg(ptb + p)) * a.L + j - p * a.L) *
                  a.KV + h;
  }
  const int n_valid = min(pos_b + 1, a.P * a.L);
  const int r1 = min(r0 + a.rows, n_valid);
  float* wsb = a.ws + static_cast<size_t>(bh) * a.G * S * (dv + 2);
  if (r0 >= r1) {  // the split lies past pos[b]: an empty partial
    for (int hh = 0; hh < nh; ++hh) {
      float* w = wsb + (static_cast<size_t>(g0 + hh) * S + s) * (dv + 2);
      for (int c = lane; c < dv; c += 32) w[c] = 0.f;
      if (lane == 0) {
        w[dv] = -kInf;
        w[dv + 1] = 0.f;
      }
    }
    return;
  }

  const int es = static_cast<int>(sizeof(T));
  const int kstride = round16(a.dq * es);
  const int vstride = a.alias ? 0 : round16(dv * es);
  const int stage_bytes = kTile * (kstride + vstride);
  // copies per staged row: K's, then V's (none when the pool is aliased)
  const int kch = a.dq * es / a.vec, vch = a.alias ? 0 : dv * es / a.vec;
  const int nwq = (a.dq * es + 3) / 4, nwv = (dv * es + 3) / 4;
  const int ntiles = (r1 - r0 + kTile - 1) / kTile;

  if ((a.dq * es) % 4) {  // odd bf16 width: the last word's pad reads 0
    for (int i = tid * 16; i < a.stages * stage_bytes; i += kThreads * 16)
      *reinterpret_cast<uint4*>(ring + i) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();  // the row indices (and the zeroed ring) are visible
  const Stager stager{smem_u32(ring),
                      rows,
                      static_cast<const unsigned char*>(a.kpool),
                      static_cast<const unsigned char*>(a.vpool),
                      static_cast<size_t>(a.dq) * es,
                      static_cast<size_t>(a.dvp) * es,
                      stage_bytes,
                      kstride,
                      vstride,
                      kch,
                      vch,
                      a.vec,
                      r0,
                      r1,
                      ntiles,
                      warp,
                      lane};

  float m[HW], l[HW], acc[HW][VL];
#pragma unroll
  for (int hh = 0; hh < HW; ++hh) {
    m[hh] = -kInf;
    l[hh] = 0.f;
#pragma unroll
    for (int c = 0; c < VL; ++c) acc[hh][c] = 0.f;
  }

  for (int t = 0; t < a.stages - 1; ++t) stager.issue(t, t);
  // the stage tile t is read from, and the one tile t + stages - 1 fills
  int st_use = 0, st_fill = a.stages - 1;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait(a.stages - 2);  // tile t has landed (this thread's part)
    __syncthreads();  // ... everyone's; and every warp is done with t - 1
    stager.issue(t + a.stages - 1, st_fill);  // t - 1's stage
    st_fill = st_fill + 1 == a.stages ? 0 : st_fill + 1;
    const int st = st_use;
    st_use = st_use + 1 == a.stages ? 0 : st_use + 1;
    if (nh == 0) continue;
    const unsigned char* kt = ring + st * stage_bytes;
    const unsigned char* vt = a.alias ? kt : kt + kTile * kstride;
    const int vs = a.alias ? kstride : vstride;
    const int nr = min(kTile, r1 - (r0 + t * kTile));
    for (int c0 = 0; c0 < nr; c0 += RS) {
      float part[HW][RS];
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        const uint32_t* kr =
            reinterpret_cast<const uint32_t*>(kt + (c0 + r) * kstride);
#pragma unroll
        for (int hh = 0; hh < HW; ++hh) part[hh][r] = 0.f;
#pragma unroll
        for (int i = 0; i < QW; ++i) {
          const int w = lane + 32 * i;
          float kx[kPack];
          Pack<T>::unpack(w < nwq ? kr[w] : 0u, kx);
#pragma unroll
          for (int hh = 0; hh < HW; ++hh)
#pragma unroll
            for (int e = 0; e < kPack; ++e)
              part[hh][r] = fmaf(qr[hh][i * kPack + e], kx[e], part[hh][r]);
        }
      }
      const int my_r = lane / kGroup;
      const bool valid = c0 + my_r < nr;
#pragma unroll
      for (int hh = 0; hh < HW; ++hh) {
        float sc = reduce_scatter<RS>(part[hh], lane);
        sc = valid ? sc : -kInf;
        // over the RS rows: the offsets of the halving exchanges
        float mc = sc;
#pragma unroll
        for (int step = 0; step < ilog2(RS); ++step)
          mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 16 >> step));
        const float mn = fmaxf(m[hh], mc);  // finite: row c0 is valid
        const float alpha = expf(m[hh] - mn);
        const float p = valid ? expf(sc - mn) : 0.f;
        // each lane sums its own row's p; the lanes are added at the end
        l[hh] = l[hh] * alpha + p;
        m[hh] = mn;
        if (lane % kGroup == 0) p_s[(warp * RS + my_r) * HW + hh] = p;
#pragma unroll
        for (int c = 0; c < VL; ++c) acc[hh][c] *= alpha;
      }
      __syncwarp();
      // no branch per row, so the loads of all RS rows can be in flight:
      // a row past r1 (stale or unwritten shared memory) reads as 0, and
      // its p is 0
      const int nvr = min(RS, nr - c0);
#pragma unroll kPvUnroll
      for (int r = 0; r < RS; ++r) {
        float pr[HW];
#pragma unroll
        for (int hh = 0; hh < HW; ++hh)
          pr[hh] = p_s[(warp * RS + r) * HW + hh];
        const uint32_t* vr =
            reinterpret_cast<const uint32_t*>(vt + (c0 + r) * vs);
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          const int w = lane + 32 * j;
          float vx[kPack];
          Pack<T>::unpack(r < nvr && w < nwv ? vr[w] : 0u, vx);
#pragma unroll
          for (int hh = 0; hh < HW; ++hh)
#pragma unroll
            for (int e = 0; e < kPack; ++e)
              acc[hh][j * kPack + e] =
                  fmaf(pr[hh], vx[e], acc[hh][j * kPack + e]);
        }
      }
      __syncwarp();  // p_s is rewritten by the next rows
    }
  }

  // l over the row slots: lanes 2i and 2i + 1 hold the same rows
#pragma unroll
  for (int hh = 0; hh < HW; ++hh)
#pragma unroll
    for (int step = 0; step < ilog2(RS); ++step)
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 16 >> step);
#pragma unroll
  for (int hh = 0; hh < HW; ++hh) {
    if (hh < nh) {
      float* w = wsb + (static_cast<size_t>(g0 + hh) * S + s) * (dv + 2);
#pragma unroll
      for (int j = 0; j < VW; ++j)
#pragma unroll
        for (int e = 0; e < kPack; ++e) {
          const int c = (lane + 32 * j) * kPack + e;
          if (c < dv) w[c] = acc[hh][j * kPack + e];
        }
      if (lane == 0) {
        w[dv] = m[hh];
        w[dv + 1] = l[hh];
      }
    }
  }
}

__device__ __forceinline__ float split_weight(float ms, float mx) {
  return ms == -kInf ? 0.f : expf(ms - mx);
}

// One block per (b, kv, g): warp 0 turns each split's m_s into its weight
// e_s = exp(m_s - max m) in shared memory, beside l_s; then every thread
// sums the denominator and its output columns over the splits in index
// order.
__global__ void __launch_bounds__(kThreads)
    paged_attn_combine(const float* __restrict__ ws, float* __restrict__ out,
                       int S, int dv) {
  extern __shared__ float e[];  // [2][S]: e_s, then l_s
  float* l = e + S;
  const int head = blockIdx.x, tid = threadIdx.x;
  const int stride = dv + 2;
  const float* w = ws + static_cast<size_t>(head) * S * stride;
  if (tid < 32) {
    float mx = -kInf;
    for (int s = tid; s < S; s += 32) mx = fmaxf(mx, w[s * stride + dv]);
#pragma unroll
    for (int o = 16; o >= 1; o /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    for (int s = tid; s < S; s += 32) {
      e[s] = split_weight(w[s * stride + dv], mx);
      l[s] = w[s * stride + dv + 1];
    }
  }
  __syncthreads();
  float den = 0.f;
  for (int s = 0; s < S; ++s) den = fmaf(e[s], l[s], den);
  den = fmaxf(den, 1e-30f);
  float* o = out + static_cast<size_t>(head) * dv;
  for (int c = tid; c < dv; c += kThreads) {
    float x = 0.f;
    for (int s = 0; s < S; ++s) x = fmaf(e[s], w[s * stride + c], x);
    o[c] = x / den;
  }
}

template <typename T, int HW, int DL, int VL>
int run(const Args& a, cudaStream_t stream) {
  auto kernel = paged_attn_split<T, HW, DL, VL>;
  // the largest dynamic shared memory granted so far, per device: the
  // attribute is set once per instantiation and size, not per launch
  static int granted[kMaxDevices] = {};
  if (a.smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices || granted[dev] < a.smem) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) granted[dev] = a.smem;
    }
  }
  const dim3 grid(a.splits, (a.G + a.gh - 1) / a.gh, a.B * a.KV);
  kernel<<<grid, kThreads, a.smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int heads = a.B * a.KV * a.G;
  paged_attn_combine<<<heads, kThreads, 2 * a.splits * sizeof(float),
                       stream>>>(a.ws, a.out, a.splits, a.dv);
  return static_cast<int>(cudaGetLastError());
}

// the narrowest per-lane widths that hold dq and dv
template <typename T, int HW>
int run_width(const Args& a, cudaStream_t stream) {
  if (a.dq <= 64 && a.dv <= 64) return run<T, HW, 2, 2>(a, stream);
  if (a.dq <= 128 && a.dv <= 128) return run<T, HW, 4, 4>(a, stream);
  if (a.dq <= 256 && a.dv <= 256) return run<T, HW, 8, 8>(a, stream);
  return run<T, HW, 18, 16>(a, stream);
}

template <typename T>
int run_heads(int hw, const Args& a, cudaStream_t stream) {
  if (hw == 1) return run_width<T, 1>(a, stream);
  return run_width<T, 2>(a, stream);
}

}  // namespace

extern "C" {

// Launches the split kernel and the combine on `stream` and returns
// cudaGetLastError() (0 on success). The split (rows, splits, heads per
// warp hw and per block gh, ring stages, shared memory smem) comes from
// paged_attn.py:plan; ws holds B * KV * G * splits * (dv + 2) floats.
int paged_attn_launch(const void* q, const void* kpool, const void* vpool,
                      const void* pt, const void* pos, void* ws, void* out,
                      int B, int KV, int G, int dq, int dv, int dvp, int L,
                      int P, float scale, int q_bf16, int pool_bf16,
                      int alias, int vec, int rows, int splits, int hw,
                      int gh, int stages, int smem, void* stream) {
  const int es = pool_bf16 ? 2 : 4;
  if (hw != 1 && hw != 2) return cudaErrorInvalidValue;
  if (L < 1 || rows < L || rows % L) return cudaErrorInvalidValue;
  const int need = p_bytes(hw) + row_bytes(rows) +
                   stages * kTile *
                       (round16(dq * es) + (alias ? 0 : round16(dv * es)));
  // the combine keeps 2 S floats in its 48 KB of shared memory
  if (stages < 2 || stages > kMaxStages || smem < need || dq > 576 ||
      dv > 512 || gh < 1 || gh > kWarps * hw || splits < 1 ||
      splits * 8 > 48 * 1024 || B * KV * G > 0x7fffffff)
    return cudaErrorInvalidValue;
  const Args a{q,  kpool, vpool, static_cast<const int*>(pt),
               static_cast<const int*>(pos), static_cast<float*>(ws),
               static_cast<float*>(out), B, KV, G, dq, dv, dvp, L, P, scale,
               q_bf16, alias, vec, rows, splits, gh, stages, smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_bf16) return run_heads<__nv_bfloat16>(hw, a, s);
  return run_heads<float>(hw, a, s);
}

}  // extern "C"
