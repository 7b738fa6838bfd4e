// flash_attention.cu — causal / sliding-window GQA flash attention, on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py: flash_attention_bhsd
//   (body _flash_kernel; wrapper ops.flash_attention).
// Plain version: src/repro_torch/kernels/flash_attention/ref.py
//   (flash_attention_ref); the kernel agrees with it to rounding (float32
//   math, another summation order).
//
// What it computes. q [B, S, H, D], k and v [B, Skv, Hkv, D] in the model's
// layout (no transposes: the kernel computes its own offsets); query head
// h reads KV head h / G with G = H / Hkv, the reference's kv-major
// grouping. Query position i attends to key position j when j < Skv, j <= i
// (causal) and i - j < window (window >= 0). o [B, S, H, D] is the softmax
// of q.k / sqrt(D) over those keys times V, in float32 with an online
// softmax, cast to the input type. The TPU kernel needs S to be a multiple
// of its tile; this one takes any S: keys past Skv are masked and query
// rows past S are neither read nor written.
//
// What bounds it. At prefill sizes the work is S^2 / 2 * H * D * 4 flops
// against (S * H * D + 2 * S * Hkv * D) * 2 B of bf16 moved: S = 432,
// H 16, Hkv 8, D 128 is 0.19 GFLOP against 3.5 MB, about 54 flops per
// byte — under the bf16 tensor-core balance point (~295), so its bound on
// the card is bytes. This first kernel does its products on the float32
// CUDA cores, not the tensor cores, and is compute-bound on them; mma /
// wgmma tiles are the lever for a later change.
//
// Head dims up to 256 (RecurrentGemma's local attention is D = 256 with
// MQA, G = 10). The kernel is instantiated twice, for D <= 128 and for
// D <= 256: each thread keeps BQ * DMAX / 128 accumulators, and the D <= 128
// instance is the code it always was, so its results are unchanged. At
// D = 256 a block needs ~82 KB of shared memory, above the 48 KB default,
// and opts in to more.
//
// Design. One block (four warps) per (BQ = 16 query rows, query head).
// It loads its q rows once as float32 in shared memory, then walks the KV
// tiles of BK = 32 keys that the mask leaves live (causal: up to the tile
// of its last row; window: from the tile of its first row minus the
// window), so dead tiles are never loaded; skipping them is exact because
// a fully masked tile leaves m, l and acc unchanged. Per tile: K and V to
// shared memory; eight threads per query row each form four q.k dots
// (padded rows avoid bank conflicts), the row's max and sum come from
// shuffles inside the eight lanes, and the probabilities go to shared
// memory; then each thread updates the acc elements it owns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;   // threads per block (4 warps)
constexpr int BQ = 16;    // query rows per block
constexpr int BK = 32;    // keys per tile
constexpr int RT = NT / BQ;   // threads per query row (8)
constexpr int CPT = BK / RT;  // keys per thread in the logits phase (4)
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
  int b, s, skv, h, hkv, d, causal, window;
  float scale;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_kernel(Shape sh, const T* __restrict__ q,
                                                   const T* __restrict__ k,
                                                   const T* __restrict__ v, T* __restrict__ o) {
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / sh.h, h = bh - b * sh.h;
  const int kvh = h / (sh.h / sh.hkv);
  constexpr int EMAX = BQ * DMAX / NT;  // acc elements per thread
  const int D = sh.d, DP = D + 1;
  const int tid = threadIdx.x;
  const int r = tid / RT, cl = tid - r * RT;  // logits phase: row, first key

  extern __shared__ float smem[];
  float* q_s = smem;                // [BQ][D + 1]
  float* k_s = q_s + BQ * DP;       // [BK][D + 1]
  float* v_s = k_s + BK * DP;       // [BK][D]
  float* p_s = v_s + BK * D;        // [BQ][BK]
  float* alpha_s = p_s + BQ * BK;   // [BQ]
  float* l_s = alpha_s + BQ;        // [BQ]

  const int q0 = qt * BQ;
  const int q_last = min(q0 + BQ, sh.s) - 1;
  const long long q_row = (long long)sh.h * D;     // stride of one position in q / o
  const long long kv_row = (long long)sh.hkv * D;  // stride of one position in k / v
  const long long qbase = (long long)b * sh.s * q_row + (long long)h * D;
  const long long kbase = (long long)b * sh.skv * kv_row + (long long)kvh * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, dd = i - rr * D;
    q_s[rr * DP + dd] = q0 + rr < sh.s ? to_f(q[qbase + (long long)(q0 + rr) * q_row + dd]) : 0.f;
  }

  // live key tiles [j_lo, j_hi]
  const int nk = (sh.skv + BK - 1) / BK;
  int j_hi = nk - 1;
  if (sh.causal) j_hi = min(j_hi, q_last / BK);
  int j_lo = 0;
  if (sh.window >= 0) {
    const int first_key = q0 - sh.window + 1;
    j_lo = first_key > 0 ? first_key / BK : 0;
  }

  float m = NEG_INF, l = 0.f;  // row r's running stats (replicated over its RT lanes)
  float acc[EMAX];
#pragma unroll
  for (int i = 0; i < EMAX; ++i) acc[i] = 0.f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's readers are done (and q_s is loaded)
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, dd = i - c * D;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < sh.skv) {
        const long long off = kbase + (long long)(k0 + c) * kv_row + dd;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      k_s[c * DP + dd] = kx;
      v_s[c * D + dd] = vx;
    }
    __syncthreads();
    // logits of row r against keys cl + RT * u
    float s[CPT];
#pragma unroll
    for (int u = 0; u < CPT; ++u) s[u] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      const float qv = q_s[r * DP + dd];
#pragma unroll
      for (int u = 0; u < CPT; ++u) s[u] += qv * k_s[(cl + RT * u) * DP + dd];
    }
    const int qpos = q0 + r;
    float mx = NEG_INF;
    bool valid[CPT];
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int kpos = k0 + cl + RT * u;
      bool ok = kpos < sh.skv;
      if (sh.causal) ok = ok && qpos >= kpos;
      if (sh.window >= 0) ok = ok && (qpos - kpos) < sh.window;
      valid[u] = ok;
      s[u] = ok ? s[u] * sh.scale : NEG_INF;
      mx = fmaxf(mx, s[u]);
    }
    // the RT lanes of row r are consecutive lanes of one warp
#pragma unroll
    for (int off = RT / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const float pv = valid[u] ? expf(s[u] - m_new) : 0.f;
      p_s[r * BK + cl + RT * u] = pv;
      sum += pv;
    }
#pragma unroll
    for (int off = RT / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float alpha = expf(m - m_new);
    l = l * alpha + sum;
    m = m_new;
    if (cl == 0) alpha_s[r] = alpha;
    __syncthreads();
    // acc[row, d] = acc * alpha[row] + sum_c p[row, c] v[c, d]
#pragma unroll
    for (int i = 0; i < EMAX; ++i) {
      const int el = tid + i * NT;
      if (el < BQ * D) {
        const int rr = el / D, dd = el - rr * D;
        float pv = 0.f;
#pragma unroll 8
        for (int c = 0; c < BK; ++c) pv += p_s[rr * BK + c] * v_s[c * D + dd];
        acc[i] = acc[i] * alpha_s[rr] + pv;
      }
    }
  }
  if (cl == 0) l_s[r] = l;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < EMAX; ++i) {
    const int el = tid + i * NT;
    if (el < BQ * D) {
      const int rr = el / D, dd = el - rr * D;
      if (q0 + rr < sh.s)
        o[qbase + (long long)(q0 + rr) * q_row + dd] = from_f<T>(acc[i] / fmaxf(l_s[rr], 1e-30f));
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch_d(const Shape& sh, const void* q, const void* k, const void* v, void* o,
                     cudaStream_t stream) {
  const int dp = sh.d + 1;
  const size_t smem =
      sizeof(float) * (size_t)(BQ * dp + BK * dp + BK * sh.d + BQ * BK + 2 * BQ);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((sh.s + BQ - 1) / BQ, sh.b * sh.h);
  flash_kernel<T, DMAX><<<grid, NT, smem, stream>>>(sh, static_cast<const T*>(q),
                                                    static_cast<const T*>(k),
                                                    static_cast<const T*>(v), static_cast<T*>(o));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Shape& sh, const void* q, const void* k, const void* v, void* o,
                   cudaStream_t stream) {
  if (sh.d <= 128) return launch_d<T, 128>(sh, q, k, v, o, stream);
  return launch_d<T, DMAX_ALL>(sh, q, k, v, o, stream);
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Flash attention on `stream`. q and o are [b, s, h, d], k and v [b, skv,
// hkv, d], all contiguous, float32 (bf16 == 0) or bfloat16 (bf16 != 0);
// window < 0 means no window. Returns the cudaError_t of the launch.
int flash_attention_launch(int b, int s, int skv, int h, int hkv, int d, int causal, int window,
                           int bf16, float scale, const void* q, const void* k, const void* v,
                           void* o, void* stream) {
  if (b < 1 || s < 1 || skv < 1 || hkv < 1 || h < hkv || h % hkv != 0 || d < 1 || d > DMAX_ALL ||
      (long long)b * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{b, s, skv, h, hkv, d, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return static_cast<int>(launch<__nv_bfloat16>(sh, q, k, v, o, st));
  return static_cast<int>(launch<float>(sh, q, k, v, o, st));
}

}  // extern "C"
