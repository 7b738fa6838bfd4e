// decode_attention.cu — paged decode attention over a KV block pool, on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py: paged_decode_attention_kernel
//   (body _decode_kernel).
// Plain version: src/repro_torch/kernels/decode_attention/ref.py
//   (paged_decode_attention_ref); the kernel agrees with it to rounding
//   (float32 math, another summation order).
//
// What it computes. One decode token per sequence: q [B, Hkv, G, D] (the
// G query heads that share KV head h), pools [N, page, Hkv, D], a block
// table tbl [B, P] and lengths [B]. Position t of sequence b lives in page
// tbl[b, t / page] at row t % page; positions t >= lengths[b] and pages
// with tbl < 0 (holes) are masked. o[b, h, g] is the softmax-weighted sum
// of V over the unmasked positions, computed in float32 with an online
// softmax (running max m, normaliser l, accumulator acc) and cast to the
// input type; a row with no unmasked position gives 0 (acc / max(l, 1e-30)).
//
// What bounds it. Bytes: every live K and V row is read once, 2 * D * 2 B
// per position and KV head in bf16, against 4 * G * D flops — about one
// flop per byte, far below the card's ~295 flops per byte in bf16. At the
// serving path's shape (B 4, Hkv 8, G 2, D 128, 448 positions) that is
// 7.3 MB per layer, 2.2 us at 3.35 TB/s.
//
// Head dims up to 256 and groups up to 16 (RecurrentGemma's local attention
// is D = 256, G = 10). The kernel is instantiated twice, for D <= 128 and
// for D <= 256: each thread keeps GMAX * DMAX / 128 accumulators, and the
// D <= 128 instance is the code it always was, so its results are
// unchanged. At G 10, D 256 a block needs ~77 KB of shared memory, above
// the 48 KB default, and opts in to more.
//
// Design. One block per (KV head, sequence), four warps. The block walks
// the table in order, skips holes and stops at the first page past the
// length (such pages leave m, l and acc exactly unchanged, as the
// reference's masked updates do). Each page is taken in chunks of TC = 32
// positions: K and V rows are staged in shared memory as float32; each
// warp forms q.k for a share of the (head, position) pairs, lanes over D
// with a shuffle reduction; then one warp per head runs the online-softmax
// update with lane = position; then every thread updates its own acc
// elements (thread-owned, so no atomics). Simple and exact in structure;
// with only B * Hkv blocks it is latency-bound, and splitting the pages
// of one sequence over several blocks is the lever for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;      // threads per block (4 warps)
constexpr int NW = NT / 32;  // warps per block
constexpr int TC = 32;       // positions per staged chunk (one per lane)
constexpr int GMAX = 16;     // most query heads per KV head
constexpr int DMAX_ALL = 256;  // largest head dim
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Shape {
  int b, hkv, g, d, page, p, n_pool;
  float scale;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) paged_decode_kernel(Shape sh, const T* __restrict__ q,
                                                          const T* __restrict__ k_pool,
                                                          const T* __restrict__ v_pool,
                                                          const int* __restrict__ tbl,
                                                          const int* __restrict__ lengths,
                                                          T* __restrict__ o) {
  constexpr int EMAX = GMAX * DMAX / NT;  // acc elements per thread
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = sh.g, D = sh.d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;             // [G][D]
  float* k_s = q_s + G * D;      // [TC][D]
  float* v_s = k_s + TC * D;     // [TC][D]
  float* p_s = v_s + TC * D;     // [G][TC] logits, then probabilities
  float* alpha_s = p_s + G * TC;  // [G]
  float* m_s = alpha_s + G;       // [G]
  float* l_s = m_s + G;           // [G]

  const long long qbase = ((long long)b * sh.hkv + h) * G * D;
  for (int i = tid; i < G * D; i += NT) q_s[i] = to_f(q[qbase + i]);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[EMAX];
#pragma unroll
  for (int i = 0; i < EMAX; ++i) acc[i] = 0.f;

  const int len = lengths[b];
  const long long row_stride = (long long)sh.hkv * D;  // one position of the pool
  for (int j = 0; j < sh.p; ++j) {
    const int start = j * sh.page;
    if (start >= len) break;
    const int e = tbl[(long long)b * sh.p + j];
    if (e < 0) continue;
    const long long base = ((long long)min(e, sh.n_pool - 1) * sh.page) * row_stride + (long long)h * D;
    const int n_tok = min(sh.page, len - start);
    for (int t0 = 0; t0 < n_tok; t0 += TC) {
      const int nt = min(TC, n_tok - t0);
      __syncthreads();  // the previous chunk's readers are done
      for (int i = tid; i < nt * D; i += NT) {
        const int t = i / D, dd = i - t * D;
        const long long off = base + (long long)(t0 + t) * row_stride + dd;
        k_s[i] = to_f(k_pool[off]);
        v_s[i] = to_f(v_pool[off]);
      }
      __syncthreads();
      // logits: pair (g, t) per warp, lanes over D
      for (int pr = warp; pr < G * TC; pr += NW) {
        const int g = pr / TC, t = pr - g * TC;
        float s = 0.f;
        if (t < nt)
          for (int dd = lane; dd < D; dd += 32) s += q_s[g * D + dd] * k_s[t * D + dd];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) p_s[g * TC + t] = t < nt ? s * sh.scale : NEG_INF;
      }
      __syncthreads();
      // online softmax: one warp per head, lane = position
      for (int g = warp; g < G; g += NW) {
        const bool valid = lane < nt;
        const float x = p_s[g * TC + lane];
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, mx);
        const float pv = valid ? expf(x - m_new) : 0.f;
        float sum = pv;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        p_s[g * TC + lane] = pv;
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          alpha_s[g] = alpha;
          l_s[g] = l_s[g] * alpha + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
      // acc[g, d] = acc * alpha[g] + sum_t p[g, t] v[t, d]
#pragma unroll
      for (int i = 0; i < EMAX; ++i) {
        const int el = tid + i * NT;
        if (el < G * D) {
          const int g = el / D, dd = el - g * D;
          float pv = 0.f;
          for (int t = 0; t < nt; ++t) pv += p_s[g * TC + t] * v_s[t * D + dd];
          acc[i] = acc[i] * alpha_s[g] + pv;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < EMAX; ++i) {
    const int el = tid + i * NT;
    if (el < G * D) {
      const int g = el / D;
      o[qbase + el] = from_f<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch_d(const Shape& sh, const void* q, const void* k, const void* v,
                     const void* tbl, const void* lengths, void* o, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(sh.g * sh.d + 2 * TC * sh.d + sh.g * TC + 3 * sh.g);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(paged_decode_kernel<T, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(sh.hkv, sh.b);
  paged_decode_kernel<T, DMAX><<<grid, NT, smem, stream>>>(
      sh, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(tbl), static_cast<const int*>(lengths), static_cast<T*>(o));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Shape& sh, const void* q, const void* k, const void* v, const void* tbl,
                   const void* lengths, void* o, cudaStream_t stream) {
  if (sh.d <= 128) return launch_d<T, 128>(sh, q, k, v, tbl, lengths, o, stream);
  return launch_d<T, DMAX_ALL>(sh, q, k, v, tbl, lengths, o, stream);
}

}  // namespace

extern "C" {

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One decode step of paged attention on `stream`. q and o are [b, hkv, g,
// d]; k_pool and v_pool [n_pool, page, hkv, d], all contiguous, float32
// (bf16 == 0) or bfloat16 (bf16 != 0); tbl int32 [b, p]; lengths int32 [b].
// Returns the cudaError_t of the launch.
int decode_attention_launch(int b, int hkv, int g, int d, int page, int p, int n_pool, int bf16,
                            float scale, const void* q, const void* k_pool, const void* v_pool,
                            const void* tbl, const void* lengths, void* o, void* stream) {
  if (b < 1 || hkv < 1 || g < 1 || g > GMAX || d < 1 || d > DMAX_ALL || page < 1 || p < 1 ||
      n_pool < 1 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{b, hkv, g, d, page, p, n_pool, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return static_cast<int>(launch<__nv_bfloat16>(sh, q, k_pool, v_pool, tbl, lengths, o, s));
  return static_cast<int>(launch<float>(sh, q, k_pool, v_pool, tbl, lengths, o, s));
}

}  // extern "C"
