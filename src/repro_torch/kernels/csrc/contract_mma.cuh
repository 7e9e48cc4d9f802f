// The scaled contraction of clip_reduce.cu and scale_contract.cu for
// bfloat16 inputs, on Hopper's tensor cores (sm_90a):
//
//     out[z][i, j] = sum_b f_b(i, j) * sum_t a[b, t, i] g[b, t, j]
//
// for a (NB, T, din), g (NB, T, dout) bfloat16 (NB = S B examples, slice s
// owning examples s B .. s B + B - 1), float factors and a float
// (din, dout) output per slice. f_b(i, j) is the example's factor, or with
// M > 1 blocks its factor of the block of column j (axis "out") or of row
// i (axis "in"), blocks W = dout / M or din / M wide.
//
// One block owns one 128 (din) x BN (dout) output tile, BN = 64 or 128,
// and its 256 threads are two warpgroups of 64 din rows each. The rows
// of one example are the wgmma K axis, in stages of 64: a stage holds the
// 64 rows of a[b, t0:t0+64, i-tile] and g[b, t0:t0+64, j-tile] as boxes
// of 64 features x 64 rows, 128-byte swizzled, exactly as they lie in
// memory (M- and N-major operands: wgmma's transpose flags take them
// without a transposing copy). A ring of 4 stages is filled four stages
// ahead by TMA (3-D tensor maps over (d, T, NB), so rows past an example's
// end load as zeros) where the feature stride and the base allow it, else
// by plain 2-byte loads, all in flight at once, into the same swizzled
// layout (odd widths, granite's 49,155-wide head).
//
// The factor. Each warpgroup keeps two register accumulators: `tmp` sums
// one example's A_bᵀ G_b by wgmma (bf16 products are exact in f32, summed
// in f32; the first k-step of an example starts from scale-d = 0), and at
// the example's end acc = fmaf(f, tmp, acc) in f32, f read from a
// per-stage factor vector in shared memory (per column for axis "out",
// per row otherwise). The factor is never rounded to bf16, so the
// sensitivity bound holds, and each tensor-core sum spans only T rows.
//
// Small grids. Where a slice has fewer than 67 output tiles, the examples
// are split into `splits` equal ranges (at most B), each writing a partial
// tile to a buffer the caller allocates; split_reduce sums the partials in
// split order. The split depends only on (B, din, dout), never on S, so
// scale_contract's slice s and clip_reduce of the same inputs sum in the
// same order. No atomics: the result is deterministic.
//
// The output: each thread stores its fragment as float2 pairs (a warp
// writes 32 contiguous bytes per row), into the tile of slice s, or of
// its partial.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper_ptx.cuh"

namespace contract_mma {

using namespace hopper_ptx;

constexpr int kBM = 128;            // din rows of the output tile
constexpr int kKS = 64;             // rows of one example per stage
constexpr int kStages = 4;          // ring depth
constexpr int kThreads = 256;       // two consumer warpgroups
constexpr int kAtom = 64;           // bf16 features of one 128-byte row
constexpr int kBoxBytes = kKS * 128;  // one 64-feature x 64-row box: 8 KB
constexpr int kSplitTiles = 132;    // split while tiles * splits <= this
constexpr int kFv = 128;            // factor-vector length (max(kBM, BN))

template <int BN>
struct Tile {
  static_assert(BN == 64 || BN == 128, "BN is 64 or 128");
  static constexpr int kABoxes = kBM / kAtom;
  static constexpr int kGBoxes = BN / kAtom;
  static constexpr int kStageBytes = (kABoxes + kGBoxes) * kBoxBytes;
  static constexpr int kTxBytesA = kABoxes * kBoxBytes;
  static constexpr int kTxBytesG = kGBoxes * kBoxBytes;
  // 1024 bytes of alignment slack (the swizzle needs 1024-aligned boxes),
  // the ring, one factor vector and one mbarrier per stage
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + kStages * kFv * 4 + kStages * 8;
};

struct Params {
  CUtensorMap map_a, map_g;  // valid where use_tma_a / use_tma_g
  const __nv_bfloat16* a;
  const __nv_bfloat16* g;
  const float* factors;  // (S B, M)
  float* out;            // (S splits, din, dout) partials if splits > 1
  int B, T, din, dout;
  int M, W, axis_in;     // M blocks of width W along din (axis_in) or dout
  int splits, m_fast;    // m_fast: din tiles along grid x
  int use_tma_a, use_tma_g;
};

// The tile width for a dout.
inline int tile_n(int dout) { return dout <= 64 ? 64 : 128; }

// Example ranges per slice (see the header note).
inline int splits(int B, int din, int dout) {
  const long tiles = static_cast<long>((din + kBM - 1) / kBM) *
                     ((dout + tile_n(dout) - 1) / tile_n(dout));
  long s = kSplitTiles / tiles;
  if (s < 1) s = 1;
  return static_cast<int>(s < B ? s : B);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled MN-major operand:
// LBO = the stride between 64-feature boxes, SBO = 8 rows of 128 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kBoxBytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= Aᵀ G over 16 rows: A (64 din x 16 rows) and G (16 rows x N dout)
// both MN-major in shared memory (imm-trans-a = imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_g,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_g), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_g,
                                              int accumulate) {
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
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
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
      : "l"(desc_a), "l"(desc_g), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2],
                                           uint64_t desc_a, uint64_t desc_g,
                                           int accumulate);
template <>
__device__ __forceinline__ void wgmma_tile<64>(float (&d)[32], uint64_t da,
                                               uint64_t dg, int acc) {
  wgmma_m64n64(d, da, dg, acc);
}
template <>
__device__ __forceinline__ void wgmma_tile<128>(float (&d)[64], uint64_t da,
                                                uint64_t dg, int acc) {
  wgmma_m64n128(d, da, dg, acc);
}

// NBOX consecutive 64-feature x kKS-row boxes of one operand by plain
// 2-byte loads (rows of any width or alignment), written in TMA's 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)); rows past T and
// features past d are zeros. Every load is issued before the first store,
// so one memory latency covers the stage. Called by all kThreads threads.
template <int NBOX>
__device__ __forceinline__ void load_boxes(uint8_t* dst,
                                           const __nv_bfloat16* src, int d,
                                           int T, int f0, int t0, int nb) {
  constexpr int kRowStep = kThreads / kAtom;  // rows between a thread's
  constexpr int kPer = kKS / kRowStep;        // elements of one box
  const int c = threadIdx.x % kAtom, r0 = threadIdx.x / kAtom;
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
  const size_t row0 = (static_cast<size_t>(nb) * T + t0 + r0) * d;
  unsigned short v[NBOX][kPer];
#pragma unroll
  for (int q = 0; q < NBOX; ++q) {
    const int f = f0 + q * kAtom + c;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int t = t0 + r0 + k * kRowStep;
      v[q][k] = (t < T && f < d)
                    ? __ldg(s16 + row0 + static_cast<size_t>(k) * kRowStep * d
                            + f)
                    : static_cast<unsigned short>(0);
    }
  }
#pragma unroll
  for (int q = 0; q < NBOX; ++q)
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int r = r0 + k * kRowStep;
      *reinterpret_cast<unsigned short*>(
          dst + q * kBoxBytes + r * 128 + (((c >> 3) ^ (r & 7)) << 4) +
          (c & 7) * 2) = v[q][k];
    }
}

// A block's accumulator fragments (m64nN per warpgroup: rows r, r + 8 of
// warp w's 16, r = m0 + 16 w + lane / 4; columns 8 j + 2 (lane % 4) +
// {0, 1}) into the float (din, dout) matrix `out`, as float2 pairs where
// dout is even; rows past din and columns past dout are not stored.
template <int kRegs>
__device__ __forceinline__ void store_tile(const float (&acc)[kRegs],
                                           float* out, int m0, int n0,
                                           int din, int dout) {
  const int lane = threadIdx.x % 32;
  const int r = m0 + (threadIdx.x / 32) * 16 + lane / 4;
  const bool pairs = (dout % 2) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r + 8 * h;
    if (i >= din) continue;
    float* row = out + static_cast<size_t>(i) * dout;
#pragma unroll
    for (int j = 0; j < kRegs / 4; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs && col + 1 < dout) {
        *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
      } else {
        if (col < dout) row[col] = v0;
        if (col + 1 < dout) row[col + 1] = v1;
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
contract_kernel(const __grid_constant__ Params p) {
  using Cfg = Tile<BN>;
  constexpr int kRegs = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* fvs = reinterpret_cast<float*>(smem + kStages * Cfg::kStageBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(fvs + kStages * kFv);

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32,
            lane = tid % 32;
  const int tm = p.m_fast ? blockIdx.x : blockIdx.y;
  const int tn = p.m_fast ? blockIdx.y : blockIdx.x;
  const int z = blockIdx.z, s = z / p.splits, part = z % p.splits;
  const int m0 = tm * kBM, n0 = tn * BN;
  const int b_lo = static_cast<int>(static_cast<long>(part) * p.B / p.splits);
  const int b_hi =
      static_cast<int>(static_cast<long>(part + 1) * p.B / p.splits);
  const int chunks = (p.T + kKS - 1) / kKS;
  const int n_it = (b_hi - b_lo) * chunks;
  const bool any_tma = p.use_tma_a || p.use_tma_g;
  const int tx_bytes = (p.use_tma_a ? Cfg::kTxBytesA : 0) +
                       (p.use_tma_g ? Cfg::kTxBytesG : 0);

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Stage `it`'s rows: example b_lo + it / chunks, rows t0 .. t0 + kKS.
  auto load = [&](int it) {
    const int st = it % kStages;
    const int nb = s * p.B + b_lo + it / chunks;
    const int t0 = (it % chunks) * kKS;
    uint8_t* sa = smem + st * Cfg::kStageBytes;
    uint8_t* sg = sa + Cfg::kTxBytesA;
    if (tid < kFv) {  // the factor of each output row or column of the tile
      const int base = p.axis_in ? m0 : n0;
      const int lim = (p.axis_in ? p.din : p.dout) - 1;
      const int x = base + tid < lim ? base + tid : lim;
      fvs[st * kFv + tid] = p.factors[static_cast<size_t>(nb) * p.M + x / p.W];
    }
    if (any_tma && tid == 0) {
      const uint32_t bar = smem_u32(&bars[st]);
      mbar_expect_tx(bar, tx_bytes);
      if (p.use_tma_a)
        for (int q = 0; q < Cfg::kABoxes; ++q)
          tma_load(smem_u32(sa + q * kBoxBytes), &p.map_a, bar,
                   m0 + q * kAtom, t0, nb);
      if (p.use_tma_g)
        for (int q = 0; q < Cfg::kGBoxes; ++q)
          tma_load(smem_u32(sg + q * kBoxBytes), &p.map_g, bar,
                   n0 + q * kAtom, t0, nb);
    }
    if (!p.use_tma_a)
      load_boxes<Cfg::kABoxes>(sa, p.a, p.din, p.T, m0, t0, nb);
    if (!p.use_tma_g)
      load_boxes<Cfg::kGBoxes>(sg, p.g, p.dout, p.T, n0, t0, nb);
    if (!p.use_tma_a || !p.use_tma_g)  // generic writes -> wgmma's proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };

  float acc[kRegs], tmp[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) acc[i] = tmp[i] = 0.f;

  for (int it = 0; it < kStages && it < n_it; ++it) load(it);
  __syncthreads();

  // Iteration it's group reads stage it % kStages; once both warpgroups
  // have finished it (a barrier after their waits) the stage is refilled
  // with iteration it + kStages's rows.
  auto issue = [&](int it, bool first) {
    const int st = it % kStages;
    if (any_tma) mbar_wait(smem_u32(&bars[st]), (it / kStages) & 1);
    const uint32_t sa = smem_u32(smem + st * Cfg::kStageBytes);
    const uint32_t sg = sa + Cfg::kTxBytesA;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKS / 16; ++kk)
      wgmma_tile<BN>(tmp, desc(sa + wg * kBoxBytes + kk * 2048),
                     desc(sg + kk * 2048), !first || kk > 0);
    wgmma_commit();
  };
  auto refill = [&](int it) {
    if (it + kStages < n_it) load(it + kStages);
  };

  // One example per pass: its chunks are a wgmma mainloop that keeps one
  // group in flight across the barrier and the refill (every join of the
  // loop sees one group in flight, so ptxas inserts no drain), then the
  // drain and acc += f * tmp in f32.
  for (int it = 0; it < n_it;) {
    issue(it, true);
    for (int c = 1; c < chunks; ++c) {
      issue(it + c, false);
      wgmma_wait<1>();
      __syncthreads();
      refill(it + c - 1);
    }
    it += chunks;
    wgmma_wait<0>();
    fence_regs(tmp);
    const float* fv = fvs + ((it - 1) % kStages) * kFv;
    if (p.axis_in) {
      const int r = wg * 64 + warp * 16 + lane / 4;
      const float f0 = fv[r], f1 = fv[r + 8];
#pragma unroll
      for (int j = 0; j < kRegs / 4; ++j) {
        acc[4 * j] = fmaf(f0, tmp[4 * j], acc[4 * j]);
        acc[4 * j + 1] = fmaf(f0, tmp[4 * j + 1], acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(f1, tmp[4 * j + 2], acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(f1, tmp[4 * j + 3], acc[4 * j + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRegs / 4; ++j) {
        const float2 f =
            *reinterpret_cast<const float2*>(fv + 8 * j + 2 * (lane % 4));
        acc[4 * j] = fmaf(f.x, tmp[4 * j], acc[4 * j]);
        acc[4 * j + 1] = fmaf(f.y, tmp[4 * j + 1], acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(f.x, tmp[4 * j + 2], acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(f.y, tmp[4 * j + 3], acc[4 * j + 3]);
      }
    }
    __syncthreads();  // the last chunk's stage and factors are read
    refill(it - 1);
  }

  store_tile(acc, p.out + static_cast<size_t>(z) * p.din * p.dout, m0, n0,
             p.din, p.dout);
}

// out[s] = sum over p of part[s splits + p], p in order.
__global__ void split_reduce(const float* __restrict__ part,
                             float* __restrict__ out, int splits,
                             size_t per_slice, size_t total) {
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t s = e / per_slice, i = e - s * per_slice;
    const float* src = part + s * splits * per_slice + i;
    float v = src[0];
    for (int q = 1; q < splits; ++q) v += src[q * per_slice];
    out[e] = v;
  }
}

// 3-D map over x (NB, T, d) bf16 with 64-feature x kKS-row boxes.
inline bool make_map(CUtensorMap* map, const void* x, int d, int T, int nb) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(nb)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(d) * T * 2};
  const cuuint32_t box[3] = {kAtom, kKS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA takes an operand whose rows are 16-byte multiples from a 16-byte
// aligned base; plain loads take the rest.
inline bool tma_ok(const void* x, int d) {
  return d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <int BN>
int launch_bn(Params& p, int S, float* out, cudaStream_t stream) {
  const int m_tiles = (p.din + kBM - 1) / kBM;
  const int n_tiles = (p.dout + BN - 1) / BN;
  const dim3 grid(p.m_fast ? m_tiles : n_tiles, p.m_fast ? n_tiles : m_tiles,
                  S * p.splits);
  cudaError_t err = cudaFuncSetAttribute(
      contract_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<BN>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  contract_kernel<BN><<<grid, kThreads, Tile<BN>::kSmem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  const size_t per_slice = static_cast<size_t>(p.din) * p.dout;
  const size_t total = per_slice * S;
  const size_t want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  split_reduce<<<blocks, 256, 0, stream>>>(p.out, out, p.splits, per_slice,
                                           total);
  return static_cast<int>(cudaGetLastError());
}

// The whole contraction of S slices of B examples; `part` holds
// S * splits(B, din, dout) partial (din, dout) tiles when that is > 1.
inline int launch(const void* a, const void* g, const float* factors,
                  float* out, float* part, int S, int B, int T, int din,
                  int dout, int M, int axis_in, cudaStream_t stream) {
  Params p;
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.factors = factors;
  p.B = B;
  p.T = T;
  p.din = din;
  p.dout = dout;
  p.M = M;
  // one block: every row or column of the tile reads the example's factor
  p.axis_in = M == 1 ? 1 : axis_in;
  p.W = M == 1 ? din : (axis_in ? din / M : dout / M);
  p.splits = splits(B, din, dout);
  // grid x runs the tiles of the narrower operand, so a wave of blocks
  // reads it whole (it stays in L2) and shares the other's slabs
  p.m_fast = din <= dout;
  p.out = p.splits > 1 ? part : out;
  p.use_tma_a = tma_ok(a, din);
  p.use_tma_g = tma_ok(g, dout);
  if ((p.use_tma_a || p.use_tma_g) && encode_tiled() == nullptr)
    return kErrNoEncoder;
  if (p.use_tma_a && !make_map(&p.map_a, a, din, T, S * B)) return kErrMap;
  if (p.use_tma_g && !make_map(&p.map_g, g, dout, T, S * B)) return kErrMap;
  return tile_n(dout) == 64 ? launch_bn<64>(p, S, out, stream)
                            : launch_bn<128>(p, S, out, stream);
}

}  // namespace contract_mma
