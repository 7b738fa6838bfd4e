// decode_attention.cu — split-KV paged decode attention over a KV block pool,
// on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py: paged_decode_attention_kernel
//   (body _decode_kernel).
// Plain version: src/repro_torch/kernels/decode_attention/ref.py
//   (paged_decode_attention_ref); the kernel agrees with it to rounding
//   (float32 math, another summation order). ref.py's
//   paged_decode_attention_split_model repeats this file's order of
//   operations (splits, chunks, combine) in plain PyTorch for the CPU tests.
//
// What it computes. One decode token per sequence: q [B, Hkv, G, D] (the
// G query heads that share KV head h), pools [N, page, Hkv, D], a block
// table tbl [B, P] and lengths [B]. Position t of sequence b lives in page
// tbl[b, t / page] at row t % page; positions t >= lengths[b] and pages
// with tbl < 0 (holes) are masked. o[b, h, g] is the softmax-weighted sum
// of V over the unmasked positions, computed in float32 and cast to the
// input type; a row with no unmasked position gives exact zeros.
//
// What bounds it. Bytes: every live K and V row is read once, 2 * D * 2 B
// per position and KV head in bf16, against 4 * G * D flops — a few flops
// per byte, far below the card's ~295 flops per byte in bf16. At the
// serving path's shape (B 4, Hkv 8, G 2, D 128, 1089 live positions) that
// is 4.5 MB, 1.3 us at 3.35 TB/s; at the hybrid's (B 2, Hkv 1, G 10, D 256,
// a ring of 2048) 4.2 MB. Both are a few microseconds of work, so what
// decides the time is how many SMs share it and how many memory round
// trips each block waits for in turn.
//
// Design (flash-decoding). The grid is (Hkv, B, n_split): split s of
// sequence b owns the positions [s * split_len, (s + 1) * split_len) that
// lie below lengths[b]. The wrapper picks n_split from the shape alone
// (ops.plan_splits: enough blocks to cover the card about twice, no split
// shorter than one chunk), so nothing is read back to the host. The split
// is over positions, not pages: the hybrid reads its ring as a single
// page of 2048, which a page split could not divide. One block of four
// warps serves all G query heads of its KV head, so each K/V row is read
// once for the G heads. A block takes its range in windows of WIN = 64
// positions: one parallel pass looks up the window's pages in the block
// table (the first window's lookup goes out with the length's load), then
// every K and V row of the window is copied into shared memory in the
// input type with 16-byte cp.async copies (neighbouring threads on
// neighbouring addresses; masked positions and holes are zero-filled and
// read nothing), one copy group per chunk of TC = 16 positions, so work on
// a chunk starts as soon as it lands. Per chunk: the logits, thread
// (position, D-slice of 8) summing q.k for four heads per pass over its K
// row and three shuffles finishing each dot; the online softmax, one
// half-warp per head with lane = position, four shuffles for the max and
// the sum, the running max m and normaliser l in registers; then P.V, each
// thread owning two adjacent columns of its heads' float32 accumulators.
// A split with nothing live writes m = -1e30, l = 0, acc = 0.
// A second small kernel combines the splits of each (b, h):
// M = max_s m_s, L = sum_s l_s e^(m_s - M),
// O = sum_s acc_s e^(m_s - M) / max(L, 1e-30) (a row with no live position
// gives exact zeros), with the splits spread over eight warps. Partials
// live in a float32 scratch that the wrapper allocates. bf16 and float32
// share this code (float32 math throughout); each is
// instantiated for D <= 128 and D <= 256 (accumulator registers). Multiply-
// adds are written as fmaf: the build keeps --fmad=false for every kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per block (4 warps)
constexpr int TC = 16;           // positions per chunk (one per half-warp lane)
constexpr int WC = 4;            // chunks staged at once
constexpr int WIN = TC * WC;     // positions staged at once (a window)
constexpr int GMAX = 16;         // most query heads per KV head
constexpr int DMAX_ALL = 256;    // largest head dim
constexpr int MAX_SPLITS = 256;  // most splits per (b, h) (ops.MAX_SPLITS)
constexpr int CW = 8;            // warps of the combine kernel
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(fill ? 16 : 0));
}

struct Shape {
  int b, hkv, g, d, page, p, n_pool, n_split, split_len;
  int vec;  // 1: rows are 16-byte aligned multiples of 16 bytes (cp.async path)
  float scale;
};

// row stride of the staged K / V chunk, in elements: D plus 16 bytes, so
// rows stay 16-byte aligned for cp.async and the logits' row reads spread
// over banks
template <typename T>
__host__ __device__ __forceinline__ int stage_stride(int d) {
  return d + 16 / static_cast<int>(sizeof(T));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until chunk ck of a window's WC copy groups has landed
__device__ __forceinline__ void wait_chunk(int ck) {
  static_assert(WC == 4, "wait_chunk covers four groups");
  switch (ck) {
    case 0: cp_async_wait<3>(); break;
    case 1: cp_async_wait<2>(); break;
    case 2: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) split_kernel(Shape sh, const T* __restrict__ q,
                                                   const T* __restrict__ k_pool,
                                                   const T* __restrict__ v_pool,
                                                   const int* __restrict__ tbl,
                                                   const int* __restrict__ lengths,
                                                   float* __restrict__ part_acc,
                                                   float* __restrict__ part_ml) {
  constexpr int VEC = 16 / sizeof(T);           // elements per 16-byte copy
  constexpr int SL = NT / TC;                   // D-slices of a logit (8 lanes)
  constexpr int GQ = 4;                         // heads per pass over a K row
  constexpr int ROUNDS = GMAX * TC / NT;        // softmax rounds (8 heads a round)
  constexpr int UMAX = GMAX * (DMAX / 2) / NT;  // heads per thread in P.V
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int G = sh.g, D = sh.d, DS = stage_stride<T>(D);
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);               // [WIN][DS]
  T* v_s = k_s + WIN * DS;                               // [WIN][DS]
  float* q_s = reinterpret_cast<float*>(v_s + WIN * DS);  // [G][D]
  float* x_s = q_s + G * D;                              // [G][TC] logits
  float* p_s = x_s + G * TC;                             // [TC][GMAX] probabilities
  float* alpha_s = p_s + TC * GMAX;                      // [G]
  int* e_s = reinterpret_cast<int*>(alpha_s + G);        // [WIN] pool page, -1: masked

  const int cap = sh.p * sh.page;
  const int lo = sp * sh.split_len;
  const int* tbl_b = tbl + (long long)b * sh.p;
  // the first window's page lookup goes out with the length's load
  const int e_first = tid < WIN && lo + tid < cap ? tbl_b[(lo + tid) / sh.page] : -1;
  const int len = min(max(lengths[b], 0), cap);
  const int hi = min(lo + sh.split_len, len);
  const long long qbase = ((long long)b * sh.hkv + h) * G * D;
  const long long row_stride = (long long)sh.hkv * D;  // one position of the pool
  const int segs = sh.vec ? D / VEC : D;  // copies per row

  float m[ROUNDS], l[ROUNDS];  // running stats of head (tid + r * NT) / TC
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
  // P.V: this thread owns columns 2 dp, 2 dp + 1 of heads gg + NG u
  const int NP = (D + 1) / 2, NG = NT / NP;
  const int dp = tid % NP, gg = tid / NP;  // gg >= NG: idle in P.V
  float acc[UMAX][2];
#pragma unroll
  for (int u = 0; u < UMAX; ++u) acc[u][0] = acc[u][1] = 0.f;
  // logits: this thread sums d = sl, sl + SL, ... of position lt
  const int lt = tid / SL, sl = tid - lt * SL;

  for (int w0 = lo; w0 < hi; w0 += WIN) {
    const int wn = min(WIN, hi - w0);  // live positions of this window
    __syncthreads();                   // the previous window's readers are done
    // the window's pages, one lookup per position, all at once
    if (tid < WIN)
      e_s[tid] = tid >= wn ? -1 : w0 == lo ? e_first : tbl_b[(w0 + tid) / sh.page];
    __syncthreads();
    // its K and V rows: one copy group per chunk (empty groups keep the count)
    const int nck = (wn + TC - 1) / TC;
#pragma unroll
    for (int ck = 0; ck < WC; ++ck) {
      if (ck < nck) {
        for (int i = tid; i < TC * segs; i += NT) {
          const int t = ck * TC + i / segs, sg = i - (i / segs) * segs;
          const int e = e_s[t], pos = w0 + t;
          const long long off =
              e < 0 ? 0
                    : ((long long)min(e, sh.n_pool - 1) * sh.page + pos % sh.page) * row_stride +
                          (long long)h * D;
          if (sh.vec) {
            cp_async16(k_s + t * DS + sg * VEC, k_pool + off + sg * VEC, e >= 0);
            cp_async16(v_s + t * DS + sg * VEC, v_pool + off + sg * VEC, e >= 0);
          } else {
            k_s[t * DS + sg] = e >= 0 ? k_pool[off + sg] : from_f<T>(0.f);
            v_s[t * DS + sg] = e >= 0 ? v_pool[off + sg] : from_f<T>(0.f);
          }
        }
      }
      cp_async_commit();
    }
    if (w0 == lo)  // q, while the first window's copies are in flight
      for (int i = tid; i < G * D; i += NT) q_s[i] = to_f(q[qbase + i]);

    for (int ck = 0; ck < nck; ++ck) {
      const int nt = min(TC, wn - ck * TC);
      const T* kc = k_s + ck * TC * DS;
      const T* vc = v_s + ck * TC * DS;
      const int* ec = e_s + ck * TC;
      wait_chunk(ck);
      __syncthreads();  // chunk ck landed everywhere; the last chunk's readers are done
      {  // logits of position lt, GQ heads per pass over its K row
        const T* kr = kc + lt * DS;
        const bool live = ec[lt] >= 0;
        for (int g0 = 0; g0 < G; g0 += GQ) {
          float s[GQ];
#pragma unroll
          for (int u = 0; u < GQ; ++u) s[u] = 0.f;
          for (int d = sl; d < D; d += SL) {
            const float kv = to_f(kr[d]);
#pragma unroll
            for (int u = 0; u < GQ; ++u)
              if (g0 + u < G) s[u] = fmaf(q_s[(g0 + u) * D + d], kv, s[u]);
          }
#pragma unroll
          for (int u = 0; u < GQ; ++u) {
            const int g = g0 + u;
            if (g < G) {  // block-uniform
              float x = s[u];
              x += __shfl_xor_sync(0xffffffffu, x, 1);
              x += __shfl_xor_sync(0xffffffffu, x, 2);
              x += __shfl_xor_sync(0xffffffffu, x, 4);
              if (sl == (g & (SL - 1))) x_s[g * TC + lt] = live ? x * sh.scale : NEG_INF;
            }
          }
        }
      }
      __syncthreads();
      // online softmax: half-warp = head, lane = position
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r) {
        if (r * NT < G * TC) {  // block-uniform: a head in this round
          const int pr = tid + r * NT;
          const int g = pr / TC, t = pr - g * TC;
          const bool live = g < G && ec[t] >= 0;
          const float x = live ? x_s[g * TC + t] : NEG_INF;
          float mx = x;
#pragma unroll
          for (int off = TC / 2; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[r], mx);
          const float pv = live ? expf(x - m_new) : 0.f;
          float sum = pv;
#pragma unroll
          for (int off = TC / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
          const float alpha = expf(m[r] - m_new);
          l[r] = l[r] * alpha + sum;
          m[r] = m_new;
          if (g < G) {
            p_s[t * GMAX + g] = pv;
            if (t == 0) alpha_s[g] = alpha;
          }
        }
      }
      __syncthreads();
      // acc[g, d] = acc * alpha[g] + sum_t p[t, g] v[t, d]
      if (gg < NG) {
#pragma unroll
        for (int u = 0; u < UMAX; ++u) {
          const int g = gg + NG * u;
          if (g >= G) break;
          const float a = alpha_s[g];
          acc[u][0] *= a;
          acc[u][1] *= a;
        }
        for (int t = 0; t < nt; ++t) {
          const float v0 = to_f(vc[t * DS + 2 * dp]);
          const float v1 = to_f(vc[t * DS + 2 * dp + 1]);  // the pad column when D is odd
#pragma unroll
          for (int u = 0; u < UMAX; ++u) {
            const int g = gg + NG * u;
            if (g >= G) break;
            const float pv = p_s[t * GMAX + g];
            acc[u][0] = fmaf(pv, v0, acc[u][0]);
            acc[u][1] = fmaf(pv, v1, acc[u][1]);
          }
        }
      }
    }
  }

  const long long pbase = (((long long)b * sh.hkv + h) * sh.n_split + sp) * G;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int pr = tid + r * NT, g = pr / TC;
    if (g < G && pr - g * TC == 0)
      reinterpret_cast<float2*>(part_ml)[pbase + g] = make_float2(m[r], l[r]);
  }
  if (gg >= NG) return;
#pragma unroll
  for (int u = 0; u < UMAX; ++u) {
    const int g = gg + NG * u;
    if (g >= G) break;
    const int c = 2 * dp;
    part_acc[(pbase + g) * D + c] = acc[u][0];
    if (c + 1 < D) part_acc[(pbase + g) * D + c + 1] = acc[u][1];
  }
}

// grid (ceil(G * D / 32), Hkv, B), CW warps: block x owns 32 consecutive
// output elements of (b, h); warp w sums the splits s = w (mod CW) for
// them, eight loads in flight at a time
template <typename T>
__global__ void __launch_bounds__(CW * 32) combine_kernel(Shape sh,
                                                          const float* __restrict__ part_acc,
                                                          const float* __restrict__ part_ml,
                                                          T* __restrict__ o) {
  constexpr int PER_LANE = MAX_SPLITS / 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = sh.g, D = sh.d, NS = sh.n_split;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ float w_s[MAX_SPLITS * GMAX];  // [s][g - g0]: e^(m_s - M) / max(L, 1e-30)
  __shared__ float red_s[CW][32];
  const int el0 = blockIdx.x * 32;
  const int g0 = el0 / D, g1 = min(el0 + 31, G * D - 1) / D, ng = g1 - g0 + 1;
  const long long sbase = ((long long)b * sh.hkv + h) * NS;  // first split of (b, h)
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + sbase * G;  // [s][g]: (m, l)
  // M, L and the split weights of each head the block touches: one warp per
  // head, each lane a few splits
  for (int hg = warp; hg < ng; hg += CW) {
    const int g = g0 + hg;
    float2 v[PER_LANE];
    float mx = NEG_INF;
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int s = lane + 32 * u;
      v[u] = s < NS ? ml[s * G + g] : make_float2(NEG_INF, 0.f);
      mx = fmaxf(mx, v[u].x);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) sum = fmaf(v[u].y, expf(v[u].x - mx), sum);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int s = lane + 32 * u;
      if (s < NS) w_s[s * ng + hg] = expf(v[u].x - mx) * inv;
    }
  }
  __syncthreads();
  const int el = el0 + lane;
  float acc = 0.f;
  if (el < G * D) {
    const int hg = el / D - g0;
    const long long step = (long long)G * D;
    const float* src = part_acc + sbase * step + el;
    for (int s0 = warp; s0 < NS; s0 += CW * 8) {
      float x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int s = s0 + CW * u;
        x[u] = s < NS ? src[s * step] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int s = s0 + CW * u;
        if (s < NS) acc = fmaf(w_s[s * ng + hg], x[u], acc);
      }
    }
  }
  red_s[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && el < G * D) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < CW; ++w) sum += red_s[w][lane];
    o[((long long)b * sh.hkv + h) * G * D + el] = from_f<T>(sum);
  }
}

template <typename T, int DMAX>
cudaError_t launch_d(const Shape& sh, const void* q, const void* k, const void* v,
                     const void* tbl, const void* lengths, void* part_acc, void* part_ml, void* o,
                     cudaStream_t stream) {
  const int ds = stage_stride<T>(sh.d);
  const size_t smem = sizeof(T) * (size_t)(2 * WIN * ds) +
                      sizeof(float) * (size_t)(sh.g * sh.d + sh.g * TC + TC * GMAX + sh.g) +
                      sizeof(int) * WIN;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(split_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(sh.hkv, sh.b, sh.n_split);
  split_kernel<T, DMAX><<<grid, NT, smem, stream>>>(
      sh, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(tbl), static_cast<const int*>(lengths),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 cgrid((sh.g * sh.d + 31) / 32, sh.hkv, sh.b);
  combine_kernel<T><<<cgrid, CW * 32, 0, stream>>>(sh, static_cast<const float*>(part_acc),
                                              static_cast<const float*>(part_ml),
                                              static_cast<T*>(o));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(Shape sh, const void* q, const void* k, const void* v, const void* tbl,
                   const void* lengths, void* part_acc, void* part_ml, void* o,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  sh.vec = sh.d % VEC == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (sh.d <= 128)
    return launch_d<T, 128>(sh, q, k, v, tbl, lengths, part_acc, part_ml, o, stream);
  return launch_d<T, DMAX_ALL>(sh, q, k, v, tbl, lengths, part_acc, part_ml, o, stream);
}

}  // namespace

extern "C" {

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One decode step of paged attention on `stream`. q and o are [b, hkv, g,
// d]; k_pool and v_pool [n_pool, page, hkv, d], all contiguous, float32
// (bf16 == 0) or bfloat16 (bf16 != 0); tbl int32 [b, p]; lengths int32 [b].
// Split s of (b, h) covers positions [s * split_len, (s + 1) * split_len);
// n_split * split_len must cover p * page. part_acc (float32 [b, hkv,
// n_split, g, d]) and part_ml (float32 [b, hkv, n_split, g, 2]) are
// scratch. Returns the cudaError_t of the launches.
int decode_attention_launch(int b, int hkv, int g, int d, int page, int p, int n_pool, int n_split,
                            int split_len, int bf16, float scale, const void* q,
                            const void* k_pool, const void* v_pool, const void* tbl,
                            const void* lengths, void* part_acc, void* part_ml, void* o,
                            void* stream) {
  if (b < 1 || hkv < 1 || g < 1 || g > GMAX || d < 1 || d > DMAX_ALL || page < 1 || p < 1 ||
      n_pool < 1 || b > 65535 || hkv > 65535 || n_split < 1 || n_split > MAX_SPLITS ||
      split_len < 1 || (long long)n_split * split_len < (long long)p * page)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{b, hkv, g, d, page, p, n_pool, n_split, split_len, 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(
        launch<__nv_bfloat16>(sh, q, k_pool, v_pool, tbl, lengths, part_acc, part_ml, o, s));
  return static_cast<int>(
      launch<float>(sh, q, k_pool, v_pool, tbl, lengths, part_acc, part_ml, o, s));
}

}  // extern "C"
