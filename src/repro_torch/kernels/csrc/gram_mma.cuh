// The ghost-norm grams of ghost_norm.cu and ghost_norm_blocked.cu for
// bfloat16 inputs, on Hopper's tensor cores (sm_90a):
//
//     out[b, m] = <S_b S_bᵀ, X_b^m X_b^mᵀ>
//
// for a shared operand S (B, T, ds) and a blocked operand X (B, T, dx)
// whose column block m is columns [m w, (m + 1) w), w = dx / M. ghost_norm
// is the case M = 1 with S the narrower of a and g.
//
// Tiles. The grams are cut into 128 x 128 tiles (i, j >= i) of sequence
// rows: nt = ceil(T / 128) per side, nt (nt + 1) / 2 per example (3 at
// T = 256). The inner product is symmetric in (i, j), so a tile i < j
// counts twice. One block of two consumer warpgroups owns one tile over
// one feature chunk: warpgroup w issues wgmma.m64n128k16 for rows
// 64 w .. 64 w + 63 of the tile, both operands K-major (features
// contiguous, as they lie in memory: no transpose flags); a diagonal tile
// passes one shared-memory box as both operands.
//
// The ring. A stage holds the 64 features of one box for rows i (and rows
// j off the diagonal): 128 rows x 128 bytes each, in TMA's 128-byte
// swizzle. Four stages are filled ahead by TMA from a 4-D tensor map over
// (w, M, T, B), so rows past T and features past a block's end load as
// zeros; where w is not a multiple of 8 (granite's 49,155-wide head, odd
// sweep widths) or the base is not 16-byte aligned, plain 2-byte loads
// fill the same layout. Only the k16 steps inside a block are issued.
//
// Phases (launches, in stream order; no atomics):
//   1  S's gram: block (b, tile, chunk c < c1) writes its f32 partial tile
//      to the workspace (straight into the reduced grams when c1 = 1);
//      `reduce_tiles` sums the c1 partials of each tile in chunk order.
//   2  X's grams chunk by chunk: <Gs, Σ_c Gx_c> = Σ_c <Gs, Gx_c>, so block
//      (b, m, tile, chunk c < c2) builds Gx_c in registers, reads the
//      reduced Gs tile in the same fragment order (it is L2-resident) and
//      reduces the product in a fixed order: one float per block, doubled
//      off the diagonal. No chunk crosses a block boundary.
//   3  `sum_rows`: out[b, m] = the sum of its partials, tile by tile,
//      chunk by chunk.
// The plan (c1, c2, workspace) depends on (B, T, ds, dx, M) only, so two
// calls give the same bits whatever the alignment of their inputs
// (ghost_norm.py:plan computes the same numbers).
//
// Precision. bf16 products are exact in f32, but the tensor cores' f32
// accumulation truncates: a chain of wgmmas reads low by a relative bias
// that grows with its length (PERF.md §6). So a chain spans at most
// kChain boxes (512 features), and chains are added into an f32 register
// tile with fadd, as contract_mma.cuh adds examples.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "gram_tile.cuh"  // pair_of, block_sum
#include "hopper_ptx.cuh"

namespace gram_mma {

using namespace hopper_ptx;

constexpr int kRows = 128;              // sequence rows per tile side
constexpr int kAtom = 64;               // bf16 features of a 128-byte row
constexpr int kBoxBytes = kRows * 128;  // one 64-feature x 128-row box
constexpr int kStageBytes = 2 * kBoxBytes;  // rows i and rows j
constexpr int kStages = 4;              // ring depth
constexpr int kThreads = 256;           // two consumer warpgroups
constexpr int kChain = 8;               // boxes per tensor-core chain
constexpr int kWave = 132;              // the plan aims a launch at a wave
constexpr int kTileFloats = kRows * kRows;
constexpr int kRegs = kTileFloats / kThreads;  // 64 per thread
// 1024 bytes of alignment slack (the swizzle needs 1024-aligned boxes),
// the ring and one mbarrier per stage
constexpr int kSmem = 1024 + kStages * kStageBytes + kStages * 8;
constexpr int kErrWorkspace = 10003;  // the workspace is smaller than the plan
static_assert(kThreads == gram_tile::kThreads, "block_sum's thread count");

struct Plan {
  int nt, tiles;  // tile rows per side; upper tiles (i <= j) per example
  int c1, c2;     // chunks of S; of each column block of X
  long long gs, part1, part2;  // floats: reduced grams, phase-1 partial
                               // tiles, phase-2 partials
  long long total() const { return gs + part1 + part2; }
};

// One wave of blocks per phase where the grid allows it: c1 = 132 / (B
// tiles) chunks of S (one at T = 1024 and beyond), c2 = 132 / (B M tiles)
// chunks per block of X, each at least one box wide.
inline Plan make_plan(int B, int T, int ds, int dx, int M) {
  Plan p;
  p.nt = (T + kRows - 1) / kRows;
  p.tiles = p.nt * (p.nt + 1) / 2;
  const long long jobs = static_cast<long long>(B) * p.tiles;
  const long long ns = (ds + kAtom - 1) / kAtom;
  const long long nw = (dx / M + kAtom - 1) / kAtom;
  long long c1 = kWave / jobs, c2 = kWave / (jobs * M);
  c1 = c1 > ns ? ns : c1;
  c2 = c2 > nw ? nw : c2;
  p.c1 = static_cast<int>(c1 < 1 ? 1 : c1);
  p.c2 = static_cast<int>(c2 < 1 ? 1 : c2);
  p.gs = jobs * kTileFloats;
  p.part1 = p.c1 > 1 ? jobs * p.c1 * kTileFloats : 0;
  p.part2 = jobs * M * p.c2;
  return p;
}

struct Params {
  CUtensorMap map;           // 4-D (w, M, T, B) map of x, where TMA loads
  const __nv_bfloat16* x;    // (B, T, M w) row-major
  const float* gs;           // phase 2: the reduced grams of S
  float* out;                // phase 1: tiles; phase 2: partials
  int T, M, w, nt, tiles, chunks;
};

// wgmma shared-memory descriptor of a 128-byte-swizzled K-major operand:
// SBO = 8 rows of 128 bytes; LBO is unused under this swizzle.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= A Bᵀ over 16 features: A (64 rows x 16) and B (128 rows x 16),
// both K-major in shared memory (imm-trans-a = imm-trans-b = 0).
__device__ __forceinline__ void wgmma_k16(float (&d)[64], uint64_t desc_a,
                                          uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// One box of 64 features x 128 rows (rows r0 .. r0 + 127) by plain
// 2-byte loads, written in TMA's 128-byte swizzle (16-byte chunk c of row
// r at chunk c ^ (r % 8)); rows past T and features past w are zeros. x
// points at column 0 of the block in row 0 of the example, ld is the row
// stride. Every load is issued before the first store, so one memory
// latency covers the box (two boxes at once would spill). Called by all
// kThreads threads.
__device__ __forceinline__ void load_box(uint8_t* dst, const __nv_bfloat16* x,
                                         int ld, int T, int w, int f0,
                                         int r0) {
  constexpr int kRowStep = kThreads / kAtom;  // rows between a thread's
  constexpr int kPer = kRows / kRowStep;      // elements of one box
  const int c = threadIdx.x % kAtom, rr = threadIdx.x / kAtom;
  const int f = f0 + c;
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(x);
  unsigned short v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int t = r0 + rr + k * kRowStep;
    v[k] = (t < T && f < w) ? __ldg(s16 + static_cast<size_t>(t) * ld + f)
                            : static_cast<unsigned short>(0);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int r = rr + k * kRowStep;
    *reinterpret_cast<unsigned short*>(dst + r * 128 +
                                       (((c >> 3) ^ (r & 7)) << 4) +
                                       (c & 7) * 2) = v[k];
  }
}

// Block (b, m, tile, chunk) of phase 1 (kDot = false: store the f32 tile
// at out[blockIdx.x]) or phase 2 (kDot = true: its inner product with the
// reduced gram of S at out[blockIdx.x]). kTma: the ring is filled by TMA,
// else by plain loads.
template <bool kDot, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
gram_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);

  const int tid = threadIdx.x, wg = tid / 128;
  int rest = blockIdx.x;
  const int c = rest % p.chunks;
  rest /= p.chunks;
  const int tile = rest % p.tiles;
  rest /= p.tiles;
  const int m = rest % p.M, b = rest / p.M;
  int ti, tj;
  gram_tile::pair_of(tile, p.nt, &ti, &tj);
  const bool diag = ti == tj;
  const int rows[2] = {ti * kRows, tj * kRows};
  const int ld = p.M * p.w;
  const int nbw = (p.w + kAtom - 1) / kAtom;
  const int box_lo = static_cast<int>(static_cast<long long>(c) * nbw /
                                      p.chunks);
  const int box_hi = static_cast<int>(static_cast<long long>(c + 1) * nbw /
                                      p.chunks);
  const int n_it = box_hi - box_lo;
  // k16 steps of the chunk's last box that lie inside the block
  const int steps_last =
      box_hi == nbw ? (p.w - (nbw - 1) * kAtom + 15) / 16 : kAtom / 16;
  const __nv_bfloat16* xb =
      p.x + static_cast<size_t>(b) * p.T * ld + static_cast<size_t>(m) * p.w;

  if (kTma && tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Stage `it`'s box: features (box_lo + it) * 64 .. + 63 of the block.
  auto load = [&](int it) {
    uint8_t* st = smem + (it % kStages) * kStageBytes;
    const int f0 = (box_lo + it) * kAtom;
    if (kTma) {
      if (tid == 0) {
        const uint32_t bar = smem_u32(&bars[it % kStages]);
        mbar_expect_tx(bar, diag ? kBoxBytes : 2 * kBoxBytes);
        tma_load_4d(smem_u32(st), &p.map, bar, f0, m, rows[0], b);
        if (!diag)
          tma_load_4d(smem_u32(st + kBoxBytes), &p.map, bar, f0, m, rows[1],
                      b);
      }
    } else {
      load_box(st, xb, ld, p.T, p.w, f0, rows[0]);
      if (!diag) load_box(st + kBoxBytes, xb, ld, p.T, p.w, f0, rows[1]);
      // generic writes -> wgmma's proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
  };

  float acc[kRegs], tmp[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) acc[i] = tmp[i] = 0.f;

  for (int it = 0; it < kStages && it < n_it; ++it) load(it);
  __syncthreads();

  // Iteration it's group reads stage it % kStages; once both warpgroups
  // have finished it (a barrier after their waits) the stage is refilled
  // with box it + kStages.
  auto issue = [&](int it, bool first) {
    const int st = it % kStages;
    if (kTma) mbar_wait(smem_u32(&bars[st]), (it / kStages) & 1);
    const uint32_t si = smem_u32(smem + st * kStageBytes);
    const uint32_t sj = diag ? si : si + kBoxBytes;
    const uint32_t sa = si + wg * (kBoxBytes / 2);  // this warpgroup's rows
    wgmma_fence();
    if (it != n_it - 1 || steps_last == kAtom / 16) {  // a whole box
#pragma unroll
      for (int kk = 0; kk < kAtom / 16; ++kk)
        wgmma_k16(tmp, desc_k(sa + kk * 32), desc_k(sj + kk * 32),
                  !first || kk > 0);
    } else {  // the block's last box: its k16 steps inside the block
#pragma unroll
      for (int kk = 0; kk < kAtom / 16; ++kk)
        if (kk < steps_last)
          wgmma_k16(tmp, desc_k(sa + kk * 32), desc_k(sj + kk * 32),
                    !first || kk > 0);
    }
    wgmma_commit();
  };
  auto refill = [&](int it) {
    if (it + kStages < n_it) load(it + kStages);
  };

  // One chain of at most kChain boxes per pass: a wgmma mainloop that
  // keeps one group in flight across the barrier and the refill (every
  // join sees one group in flight, so ptxas inserts no drain), then the
  // drain and acc += tmp in f32.
  for (int it = 0; it < n_it;) {
    const int len = n_it - it < kChain ? n_it - it : kChain;
    issue(it, true);
    for (int k = 1; k < len; ++k) {
      issue(it + k, false);
      wgmma_wait<1>();
      __syncthreads();
      refill(it + k - 1);
    }
    it += len;
    wgmma_wait<0>();
    fence_regs(tmp);
#pragma unroll
    for (int i = 0; i < kRegs; ++i) acc[i] += tmp[i];
    __syncthreads();  // the chain's last stage is read
    refill(it - 1);
  }

  // Tiles lie in fragment order: float4 q of thread tid at q kThreads + tid.
  if (!kDot) {
    float4* dst = reinterpret_cast<float4*>(
        p.out + static_cast<size_t>(blockIdx.x) * kTileFloats);
#pragma unroll
    for (int q = 0; q < kRegs / 4; ++q)
      dst[q * kThreads + tid] = make_float4(acc[4 * q], acc[4 * q + 1],
                                            acc[4 * q + 2], acc[4 * q + 3]);
  } else {
    __shared__ float warp_sum[kThreads / 32];
    const float4* gs = reinterpret_cast<const float4*>(
        p.gs + (static_cast<size_t>(b) * p.tiles + tile) * kTileFloats);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kRegs / 4; ++q) {
      const float4 v = __ldg(gs + q * kThreads + tid);
      s = fmaf(acc[4 * q], v.x, s);
      s = fmaf(acc[4 * q + 1], v.y, s);
      s = fmaf(acc[4 * q + 2], v.z, s);
      s = fmaf(acc[4 * q + 3], v.w, s);
    }
    const float total = gram_tile::block_sum(s, warp_sum);
    if (tid == 0) p.out[blockIdx.x] = (diag ? 1.f : 2.f) * total;
  }
}

// gs[job] = the sum of part[job c1 + c] over c in order (float4 lanes).
__global__ void reduce_tiles(const float4* __restrict__ part,
                             float4* __restrict__ gs, int c1, long long n4) {
  constexpr long long kTile4 = kTileFloats / 4;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n4; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long job = e / kTile4;
    const float4* src = part + job * c1 * kTile4 + (e - job * kTile4);
    float4 v = src[0];
    for (int k = 1; k < c1; ++k) {
      const float4 u = src[k * kTile4];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    gs[e] = v;
  }
}

// out[r] = the sum of row r's n partials, in order.
__global__ void sum_rows(const float* __restrict__ part,
                         float* __restrict__ out, int rows, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float s = 0.f;
  for (int k = 0; k < n; ++k) s += part[static_cast<size_t>(r) * n + k];
  out[r] = s;
}

// 4-D map over x (B, T, M, w) bf16 with 64-feature x 128-row boxes of
// one column block.
inline bool make_map(CUtensorMap* map, const void* x, int w, int M, int T,
                     int B) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(M),
      static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(M) * w * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(w) * 2, row,
                                 row * T};
  const cuuint32_t box[4] = {kAtom, 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kDot, bool kTma>
int launch_phase(const Params& p, int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gram_kernel<kDot, kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_kernel<kDot, kTma><<<blocks, kThreads, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// TMA takes column blocks whose width is a multiple of 8 (16-byte
// strides) from a 16-byte aligned base; plain loads take the rest.
template <bool kDot>
int run_phase(Params& p, int B, int blocks, cudaStream_t stream) {
  if (p.w % 8 != 0 || reinterpret_cast<uintptr_t>(p.x) % 16 != 0)
    return launch_phase<kDot, false>(p, blocks, stream);
  if (encode_tiled() == nullptr) return kErrNoEncoder;
  if (!make_map(&p.map, p.x, p.w, p.M, p.T, B)) return kErrMap;
  return launch_phase<kDot, true>(p, blocks, stream);
}

// The three phases on `stream`: s (B, T, ds), x (B, T, dx) bf16, dx a
// multiple of M; ws holds ws_floats >= make_plan(...).total() floats;
// out (B, M) float.
inline int launch(const void* s, const void* x, float* ws,
                  long long ws_floats, float* out, int B, int T, int ds,
                  int dx, int M, cudaStream_t stream) {
  const Plan pl = make_plan(B, T, ds, dx, M);
  if (ws_floats < pl.total()) return kErrWorkspace;
  float* gs = ws;
  float* part1 = gs + pl.gs;
  float* part2 = part1 + pl.part1;
  const int jobs = B * pl.tiles;

  Params p1 = {};
  p1.x = static_cast<const __nv_bfloat16*>(s);
  p1.out = pl.c1 > 1 ? part1 : gs;
  p1.T = T;
  p1.M = 1;
  p1.w = ds;
  p1.nt = pl.nt;
  p1.tiles = pl.tiles;
  p1.chunks = pl.c1;
  int rc = run_phase<false>(p1, B, jobs * pl.c1, stream);
  if (rc != 0) return rc;
  if (pl.c1 > 1) {
    const long long n4 = pl.gs / 4;
    const long long want = (n4 + 255) / 256;
    reduce_tiles<<<static_cast<int>(want < 2048 ? want : 2048), 256, 0,
                   stream>>>(reinterpret_cast<const float4*>(part1),
                             reinterpret_cast<float4*>(gs), pl.c1, n4);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }

  Params p2 = {};
  p2.x = static_cast<const __nv_bfloat16*>(x);
  p2.gs = gs;
  p2.out = part2;
  p2.T = T;
  p2.M = M;
  p2.w = dx / M;
  p2.nt = pl.nt;
  p2.tiles = pl.tiles;
  p2.chunks = pl.c2;
  rc = run_phase<true>(p2, B, jobs * M * pl.c2, stream);
  if (rc != 0) return rc;

  const int rows = B * M;
  sum_rows<<<(rows + 127) / 128, 128, 0, stream>>>(part2, out, rows,
                                                   pl.tiles * pl.c2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gram_mma
