// Paged-gather one-token GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_attn` of src/repro/kernels/paged_attn.py
// (`_paged_attn_kernel`, launched by `pl.pallas_call` in `paged_attn`).
// It computes the same function: q (B, KV, G, dq) attends, through the
// int32 page table pt (B, P), to the cache rows of kpool (N, L, KV, dq)
// and vpool (N, L, KV, dvp) whose logical index p*L + i is <= pos[b], with
// the value read truncated to dv <= dvp. Output (B, KV, G, dv) float32.
//
// Design. The TPU ran grid (b, page) in order and carried the running
// max / denominator / accumulator in VMEM from one page step to the next.
// Hopper blocks run in parallel, so here one block owns one (b, kv-head):
// it loads its own page ids from pt[b, :], walks the valid rows in tiles
// of 32 (only pages with p*L <= pos[b]: rows past pos contribute exactly 0
// to the softmax, so skipping them changes nothing), keeps max,
// denominator and the (G x dv) accumulator in f32 shared memory, and
// writes its output once, with no atomics, so the result is deterministic.
//
// Bound. The work is a few FLOPs per byte: the bound is the HBM bytes of
// the valid K/V rows (about 6.5 MB per layer per decode dispatch for
// qwen3-4b with 8 slots of up to 272 tokens, a few microseconds at
// 3.35 TB/s). This first version does not reach it: one block per
// (b, kv) fills only 64 of the 132 SMs at 8 slots and 8 KV heads, and
// each block stages its tiles synchronously. Splitting over pages
// (flash-decoding), cp.async/TMA staging and CUDA graphs come later.
//
// Inputs: float or bfloat16 (q, kpool and vpool of one type), any G,
// dq and dv up to 256, vpool may alias kpool. Every pool page id in pt
// must lie in [0, N) and pos[b] >= 0; the wrapper in paged_attn.py checks
// everything that can be checked without reading device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // cache rows per tile; one per lane in softmax
constexpr float kNegInf = -1e30f;
static_assert(kTile == 32, "the softmax step maps one tile row per lane");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// `q * scale` rounded to the input type, as the plain version scales the
// query before its f32 cast
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                  const T* __restrict__ vpool, const int* __restrict__ pt,
                  const int* __restrict__ pos, float* __restrict__ out,
                  int KV, int G, int dq, int dv, int dvp, int L, int P,
                  float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x - b * KV;
  const int tid = threadIdx.x;
  const int kstride = dq + 1;  // odd row stride: no bank conflicts

  int* page_s = reinterpret_cast<int*>(smem);  // P
  float* q_s = smem + P;                       // G * dq
  float* k_s = q_s + G * dq;                   // kTile * (dq + 1)
  float* v_s = k_s + kTile * kstride;          // kTile * dv
  float* p_s = v_s + kTile * dv;               // G * kTile
  float* m_s = p_s + G * kTile;                // G running max
  float* l_s = m_s + G;                        // G running denominator
  float* a_s = l_s + G;                        // G rescale of this tile
  float* acc = a_s + G;                        // G * dv

  int n_valid = pos[b] + 1;
  if (n_valid > P * L) n_valid = P * L;
  const int n_pages = (n_valid + L - 1) / L;
  for (int i = tid; i < n_pages; i += kThreads) page_s[i] = pt[b * P + i];
  const T* qb = q + (static_cast<size_t>(b) * KV + h) * G * dq;
  for (int i = tid; i < G * dq; i += kThreads)
    q_s[i] = round_as(to_f32(qb[i]) * scale, qb);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  for (int i = tid; i < G * dv; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int t0 = 0; t0 < n_valid; t0 += kTile) {
    const int rows = min(kTile, n_valid - t0);
    for (int e = tid; e < rows * dq; e += kThreads) {
      const int r = e / dq, d = e - r * dq, j = t0 + r;
      const size_t row =
          (static_cast<size_t>(page_s[j / L]) * L + j % L) * KV + h;
      k_s[r * kstride + d] = to_f32(kpool[row * dq + d]);
    }
    for (int e = tid; e < rows * dv; e += kThreads) {
      const int r = e / dv, d = e - r * dv, j = t0 + r;
      const size_t row =
          (static_cast<size_t>(page_s[j / L]) * L + j % L) * KV + h;
      v_s[r * dv + d] = to_f32(vpool[row * dvp + d]);
    }
    __syncthreads();

    for (int e = tid; e < G * kTile; e += kThreads) {
      const int g = e / kTile, r = e - g * kTile;
      float s = kNegInf;
      if (r < rows) {
        const float* qg = q_s + g * dq;
        const float* kr = k_s + r * kstride;
        s = 0.f;
        for (int d = 0; d < dq; ++d) s = fmaf(qg[d], kr[d], s);
      }
      p_s[e] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kThreads / 32) {
      const float s = p_s[g * kTile + lane];
      float mx = s;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(s - m_new);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * dv; e += kThreads) {
      const int g = e / dv, d = e - g * dv;
      const float* pg = p_s + g * kTile;
      float a = acc[e] * a_s[g];
      for (int r = 0; r < rows; ++r) a = fmaf(pg[r], v_s[r * dv + d], a);
      acc[e] = a;
    }
    __syncthreads();
  }

  float* ob = out + (static_cast<size_t>(b) * KV + h) * G * dv;
  for (int e = tid; e < G * dv; e += kThreads)
    ob[e] = acc[e] / fmaxf(l_s[e / dv], 1e-30f);
}

template <typename T>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* pt, const void* pos, void* out, int B, int KV, int G,
           int dq, int dv, int dvp, int L, int P, float scale,
           size_t smem, cudaStream_t stream) {
  auto kernel = paged_attn_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), static_cast<const int*>(pt),
      static_cast<const int*>(pos), static_cast<float*>(out), KV, G, dq, dv,
      dvp, L, P, scale);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory the kernel needs, in bytes; paged_attn.py:smem_bytes
// repeats it to refuse an input before launching.
size_t smem_bytes(int G, int dq, int dv, int P) {
  return sizeof(float) * (static_cast<size_t>(P) + G * dq +
                          kTile * (dq + 1) + kTile * dv + G * kTile + 3 * G +
                          G * dv);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// is_bf16: 1 for bfloat16 inputs, 0 for float.
int paged_attn_launch(const void* q, const void* kpool, const void* vpool,
                      const void* pt, const void* pos, void* out, int B,
                      int KV, int G, int dq, int dv, int dvp, int L, int P,
                      float scale, int is_bf16, void* stream) {
  const size_t smem = smem_bytes(G, dq, dv, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, kpool, vpool, pt, pos, out, B, KV, G, dq,
                                 dv, dvp, L, P, scale, smem, s);
  return launch<float>(q, kpool, vpool, pt, pos, out, B, KV, G, dq, dv, dvp,
                       L, P, scale, smem, s);
}

}  // extern "C"
