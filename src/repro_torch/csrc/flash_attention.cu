// flash_attention.cu — causal / sliding-window GQA flash attention, on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py: flash_attention_bhsd
//   (body _flash_kernel; wrapper ops.flash_attention).
// Plain version: src/repro_torch/kernels/flash_attention/ref.py
//   (flash_attention_ref); the kernel agrees with it within the
//   reference's tolerance. ref.py's flash_attention_tc_model repeats the
//   bf16 kernel's rounding (bf16 products summed in float32, P rounded to
//   bf16 before P.V) in plain PyTorch for the CPU tests.
//
// What it computes. q [B, S, H, D], k and v [B, Skv, Hkv, D] in the model's
// layout (no transposes: the kernel computes its own offsets); query head
// h reads KV head h / G with G = H / Hkv, the reference's kv-major
// grouping. Query position i attends to key position j when j < Skv, j <= i
// (causal) and i - j < window (window >= 0). o [B, S, H, D] is the softmax
// of q.k / sqrt(D) over those keys times V, with an online softmax in
// float32, cast to the input type. The TPU kernel needs S to be a multiple
// of its tile; this one takes any S: keys past Skv are masked and query
// rows past S are neither read nor written.
//
// What bounds it. At prefill sizes the work is (live pairs) * H * D * 4
// flops against (S * H * D + 2 * Skv * Hkv * D) * 2 B of bf16 moved. At
// Qwen3's S = 432 (H 16, Hkv 8, D 128) that is 0.19 GFLOP against 3.5 MB:
// bytes bound it (1.6 us at 3.35 TB/s). At the hybrid's layer (B 2,
// S 3072, H 10 on one KV head, D 256, window 2048) it is 85.9 GFLOP
// against 31 MB: the tensor cores bound it (87 us at 989 TFLOP/s).
//
// Design, bf16 (FlashAttention-2's shape on mma.sync). One block of NW
// warps owns BM = 16 * NW query rows of one (sequence, KV head), where a
// row is (position, head in group): row r is position r / G, query head
// kvh * G + r % G. The G heads that share a KV head thus share every K/V
// tile the block loads (the hybrid's 10 heads read one KV head once).
// Each warp owns 16 rows. The block keeps its Q tile in shared memory and
// walks the KV tiles of BK keys that the mask leaves live (causal: up to
// the tile of its last position; window: from the tile of its first
// position minus the window), double-buffered in shared memory with
// 16-byte cp.async copies: tile j + 1 loads while tile j is used. S = Q.K^T
// and O += P.V run on mma.sync.m16n8k16 (bf16 in, float32 accumulators),
// with fragments from ldmatrix (V through its transposing form). The
// online softmax runs on the S fragments in registers, in float32 (row
// max and sum over the four lanes that share a row: two shuffles); P is
// rounded to bf16 for P.V, as FlashAttention does, while l sums the
// float32 P. Only tiles that cross the diagonal, the window's lower edge
// or Skv are masked. Rows of shared memory are D padded to a multiple of
// 16 (DP) plus 16 bytes, which keeps ldmatrix free of bank conflicts and
// lets any D <= 256 run (the pad columns are zero). Instances, all with
// BK = 64: DP 64 and 128 with four warps; DP 256 with eight, so that at
// the hybrid's MQA a block covers ~13 positions and each K/V tile it
// takes from L2 serves 128 rows. There O alone is 128 float32 registers a
// thread (249 in all, no spills) and a block takes ~203 KB of shared
// memory, one block an SM. At the hybrid's layer on an H100 SXM (700 W)
// that measured 0.46 ms of device time against 0.54 ms for BK 32 with
// four or eight warps and 0.69 ms for BK 64 with four
// (tools/chip_tune_flash.py). --fmad=false holds for this file too; the
// softmax's multiply-adds are written as fmaf.
//
// Design, float32 (unchanged; the 3e-5 float32 tolerance rules out TF32
// tensor cores). One block (four warps) per (BQ = 16 query rows, query
// head). It loads its q rows once as float32 in shared memory, then walks
// the live KV tiles of BK = 32 keys (dead tiles are never loaded; skipping
// them is exact because a fully masked tile leaves m, l and acc
// unchanged). Per tile: K and V to shared memory; eight threads per query
// row each form four q.k dots (padded rows avoid bank conflicts), the
// row's max and sum come from shuffles inside the eight lanes, and the
// probabilities go to shared memory; then each thread updates the acc
// elements it owns. The kernel is instantiated for D <= 128 and D <= 256:
// each thread keeps BQ * DMAX / 128 accumulators.

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

// the float32 kernel's loads and stores
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Copy `rows` rows of D bf16 (source row r at src + r * stride) into a
// shared tile [n][LDS]; rows at or past `rows` are zero-filled. vec: 16-byte
// cp.async copies (D % 8 == 0 and 16-byte aligned rows), else plain loads.
template <int N, int LDS, int NTH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int rows, int D, bool vec) {
  if (vec) {
    const int segs = D / 8;
    for (int i = threadIdx.x; i < N * segs; i += NTH) {
      const int r = i / segs, c = (i - r * segs) * 8;
      const bool ok = r < rows;
      cp_async16(dst + r * LDS + c, src + (ok ? r * stride : 0) + c, ok);
    }
  } else {
    for (int i = threadIdx.x; i < N * D; i += NTH) {
      const int r = i / D, c = i - r * D;
      dst[r * LDS + c] = r < rows ? src[r * stride + c] : __float2bfloat16(0.f);
    }
  }
}

template <int DP, int BK, int NW>
__global__ void __launch_bounds__(NW * 32, 1) flash_tc_kernel(Shape sh,
                                                           const __nv_bfloat16* __restrict__ q,
                                                           const __nv_bfloat16* __restrict__ k,
                                                           const __nv_bfloat16* __restrict__ v,
                                                           __nv_bfloat16* __restrict__ o, int vec) {
  constexpr int NTH = NW * 32;  // threads
  constexpr int BM = NW * 16;   // query rows (position, head in group)
  constexpr int LDS = DP + 8;   // shared row stride (bf16): 16 bytes of pad
  constexpr int NS = BK / 8;    // n-tiles of S
  constexpr int NO = DP / 8;    // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][LDS]
  __nv_bfloat16* k_s = q_s + BM * LDS;                                // [2][BK][LDS]
  __nv_bfloat16* v_s = k_s + 2 * BK * LDS;                            // [2][BK][LDS]

  const int D = sh.d, G = sh.h / sh.hkv;
  const int n_rows = sh.s * G;
  const int r0 = blockIdx.x * BM;
  const int b = blockIdx.y / sh.hkv, kvh = blockIdx.y - b * sh.hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q_row = (long long)sh.h * D;     // one position of q / o
  const long long kv_row = (long long)sh.hkv * D;  // one position of k / v
  const __nv_bfloat16* k_b = k + (long long)b * sh.skv * kv_row + (long long)kvh * D;
  const __nv_bfloat16* v_b = v + (long long)b * sh.skv * kv_row + (long long)kvh * D;

  // zero the pad columns [D, DP) of every tile once: loads never write them
  if (D < DP) {
    constexpr int ROWS = BM + 4 * BK;
    const int pad = DP - D;
    for (int i = tid; i < ROWS * pad; i += NTH) {
      const int r = i / pad;
      q_s[r * LDS + D + (i - r * pad)] = __float2bfloat16(0.f);
    }
  }
  // Q rows: row r0 + r is position (r0 + r) / G, head kvh * G + (r0 + r) % G
  if (vec) {
    const int segs = D / 8;
    for (int i = tid; i < BM * segs; i += NTH) {
      const int r = i / segs, c = (i - r * segs) * 8;
      const int row = r0 + r;
      const bool ok = row < n_rows;
      const int pos = ok ? row / G : 0, g = ok ? row - pos * G : 0;
      cp_async16(q_s + r * LDS + c,
                 q + ((long long)b * sh.s + pos) * q_row + (long long)(kvh * G + g) * D + c, ok);
    }
  } else {
    for (int i = tid; i < BM * D; i += NTH) {
      const int r = i / D, c = i - r * D;
      const int row = r0 + r;
      __nv_bfloat16 x = __float2bfloat16(0.f);
      if (row < n_rows) {
        const int pos = row / G, g = row - pos * G;
        x = q[((long long)b * sh.s + pos) * q_row + (long long)(kvh * G + g) * D + c];
      }
      q_s[r * LDS + c] = x;
    }
  }

  // live key tiles [j_lo, j_hi] from the block's first and last positions
  const int p_lo = r0 / G, p_hi = (min(r0 + BM, n_rows) - 1) / G;
  const int nk = (sh.skv + BK - 1) / BK;
  int j_hi = nk - 1;
  if (sh.causal) j_hi = min(j_hi, p_hi / BK);
  int j_lo = 0;
  if (sh.window >= 0) {
    const int first_key = p_lo - sh.window + 1;
    j_lo = first_key > 0 ? first_key / BK : 0;
  }

  auto load_kv = [&](const __nv_bfloat16* src, __nv_bfloat16* dst, int j) {
    load_rows<BK, LDS, NTH>(dst, src + (long long)j * BK * kv_row, kv_row, sh.skv - j * BK, D, vec);
  };
  if (j_lo <= j_hi) load_kv(k_b, k_s, j_lo);
  cp_async_commit();  // group: Q and K[j_lo]
  if (j_lo <= j_hi) load_kv(v_b, v_s, j_lo);
  cp_async_commit();  // group: V[j_lo]

  // this thread's two rows in its warp's 16: lane / 4 and lane / 4 + 8
  int qpos[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) qpos[h2] = (r0 + warp * 16 + (lane >> 2) + 8 * h2) / G;
  const float sl2 = sh.scale * 1.4426950408889634f;  // scale * log2(e)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int buf = (j - j_lo) & 1;
    const __nv_bfloat16* kt = k_s + buf * BK * LDS;
    const __nv_bfloat16* vt = v_s + buf * BK * LDS;
    cp_async_wait<1>();  // K[j] (and Q) landed; V[j] may still be in flight
    __syncthreads();
    // S = Q K^T for this warp's 16 rows and BK keys
    float sc[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_s + (warp * 16 + (lane & 15)) * LDS + kk * 16 + 8 * (lane >> 4));
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t bb[4];
        ldsm_x4(bb, kt + (n2 * 16 + (lane & 7) + 8 * (lane >> 4)) * LDS + kk * 16 +
                        8 * ((lane >> 3) & 1));
        mma_bf16(sc[2 * n2], a, bb[0], bb[1]);
        mma_bf16(sc[2 * n2 + 1], a, bb[2], bb[3]);
      }
    }
    // start tile j + 1 into the other buffer (its last readers passed the
    // barrier above); empty groups keep the count uniform
    if (j < j_hi) load_kv(k_b, k_s + (buf ^ 1) * BK * LDS, j + 1);
    cp_async_commit();
    if (j < j_hi) load_kv(v_b, v_s + (buf ^ 1) * BK * LDS, j + 1);
    cp_async_commit();

    const int k0 = j * BK;
    const bool edge = k0 + BK > sh.skv || (sh.causal && k0 + BK - 1 > p_lo) ||
                      (sh.window >= 0 && k0 < p_hi - sh.window + 1);
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + nt * 8 + 2 * (lane & 3) + (c & 1);
          const int pos = qpos[c >> 1];
          bool ok = key < sh.skv;
          if (sh.causal) ok = ok && key <= pos;
          if (sh.window >= 0) ok = ok && pos - key < sh.window;
          if (!ok) sc[nt][c] = -INFINITY;
        }
    }
    // online softmax over the tile, rows h2 = 0, 1 (c = 2 * h2, 2 * h2 + 1)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) mx = fmaxf(mx, fmaxf(sc[nt][2 * h2], sc[nt][2 * h2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h2], mx);
      const float ms = m_new == -INFINITY ? 0.f : m_new * sl2;
      const float alpha = fast_exp2(fmaf(m[h2], sl2, -ms));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        sc[nt][2 * h2] = fast_exp2(fmaf(sc[nt][2 * h2], sl2, -ms));
        sc[nt][2 * h2 + 1] = fast_exp2(fmaf(sc[nt][2 * h2 + 1], sl2, -ms));
        sum += sc[nt][2 * h2] + sc[nt][2 * h2 + 1];
      }
      l[h2] = fmaf(l[h2], alpha, sum);  // this lane's share; summed over the quad at the end
      m[h2] = m_new;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        acc[i][2 * h2] *= alpha;
        acc[i][2 * h2 + 1] *= alpha;
      }
    }
    cp_async_wait<2>();  // V[j] landed
    __syncthreads();
    // O += P V, P as bf16 A fragments straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int d2 = 0; d2 < NO / 2; ++d2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vt + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDS + d2 * 16 +
                          8 * (lane >> 4));
        mma_bf16(acc[2 * d2], a, bb[0], bb[1]);
        mma_bf16(acc[2 * d2 + 1], a, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait<0>();

  // O / l, written as bf16 pairs
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float lt = l[h2];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int row = r0 + warp * 16 + (lane >> 2) + 8 * h2;
    if (row >= n_rows) continue;
    const int pos = row / G, g = row - pos * G;
    __nv_bfloat16* dst = o + ((long long)b * sh.s + pos) * q_row + (long long)(kvh * G + g) * D;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int c = i * 8 + 2 * (lane & 3);
      if (c + 1 < D && (D & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            __floats2bfloat162_rn(acc[i][2 * h2] * inv, acc[i][2 * h2 + 1] * inv);
      } else {
        if (c < D) dst[c] = __float2bfloat16(acc[i][2 * h2] * inv);
        if (c + 1 < D) dst[c + 1] = __float2bfloat16(acc[i][2 * h2 + 1] * inv);
      }
    }
  }
}

template <int DP, int BK, int NW>
cudaError_t launch_tc_d(const Shape& sh, const void* q, const void* k, const void* v, void* o,
                        cudaStream_t stream) {
  constexpr int LDS = DP + 8, BM = NW * 16;
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(BM + 4 * BK) * LDS;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(flash_tc_kernel<DP, BK, NW>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int vec = sh.d % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  const long long rows = (long long)sh.s * (sh.h / sh.hkv);
  dim3 grid((unsigned)((rows + BM - 1) / BM), sh.b * sh.hkv);
  flash_tc_kernel<DP, BK, NW><<<grid, NW * 32, smem, stream>>>(
      sh, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), vec);
  return cudaGetLastError();
}

cudaError_t launch_tc(const Shape& sh, const void* q, const void* k, const void* v, void* o,
                      cudaStream_t stream) {
  if (sh.d <= 64) return launch_tc_d<64, 64, 4>(sh, q, k, v, o, stream);
  if (sh.d <= 128) return launch_tc_d<128, 64, 4>(sh, q, k, v, o, stream);
  return launch_tc_d<256, 64, 8>(sh, q, k, v, o, stream);
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
  if (bf16) return static_cast<int>(launch_tc(sh, q, k, v, o, st));
  return static_cast<int>(launch<float>(sh, q, k, v, o, st));
}

}  // extern "C"
