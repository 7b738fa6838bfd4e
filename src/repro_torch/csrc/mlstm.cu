// mlstm.cu — the stabilized chunkwise mLSTM with its state, on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mlstm/kernel.py: mlstm_kernel (body _mlstm_kernel),
//   whose math is src/repro/models/xlstm.py: mlstm_chunkwise.
// Plain version: src/repro_torch/kernels/mlstm/ref.py (mlstm_chunkwise_ref),
//   the same chunkwise form in PyTorch; the kernel agrees with it to
//   rounding (float32 math, another summation order).
//
// What it computes. In the model's layout: q, k [B, S, H, Dk] and
// v [B, S, H, Dv] (float32 or bfloat16), the input-gate preactivations li
// and the log-sigmoid forget gates lf [B, S, H] (float32), and the state
// it starts from: the matrix memory C [B, H, Dk, Dv], the normalizer
// n [B, H, Dk] and the stabilizer m [B, H] (float32; an empty state has
// m = -1e30, never -inf, so no inf - inf appears). It returns h [B, S, H, Dv]
// float32 and the state after the last position. The sequence is cut into
// chunks of L = 64 positions: quadratic inside a chunk, recurrent (C, n, m)
// across chunks. Unlike the TPU kernel it takes the initial state and
// returns the final one (the serving cache needs both), and it takes any S:
// the last chunk may be short, and its missing positions are masked.
//
// What bounds it. At the xLSTM-125M prefill (B 4, H 4, S 1024, Dk 192,
// Dv 384, bf16 q/k/v, f32 h) it moves ~50 MB, 15 us at 3.35 TB/s, and does
// ~6 GFLOP, 90 us at the 67 TFLOP/s float32 rate of the CUDA cores: it is
// bound by operations. This first kernel does its products on the float32
// CUDA cores (without fused multiply-adds) from shared memory; tensor-core
// tiles are the lever for a later change.
//
// Design. The state does not fit one block: C alone is 192 x 384 float32 =
// 288 KB, above the 227 KB of shared memory a block can have. So each
// (batch, head) is split over Dv: one block of 256 threads per slice of
// DVB = 64 value columns (32 when Dk is large) owns that slice of C, of the
// numerator and of h, and keeps its C slice in shared memory across all
// chunks. Every block of a (batch, head) recomputes the small chunk-local
// terms that all slices share — the forget-gate cumsum, the stabilizers,
// the decay matrix, q.k and the denominator — in the same order, so they
// agree exactly; the slice-0 block writes n and m. Per chunk: q (transposed)
// and k are staged as float32, the scalars of each position are computed by
// one thread per position, then each thread forms a 4 x 4 tile of the
// weighted q.k matrix, a 4 x (DVB / 16) tile of the output and a
// ceil(Dk / 16) x (DVB / 16) tile of the C update, each an outer-product
// sum over shared memory laid out so that a warp's reads hit distinct banks
// or broadcast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int L = 64;       // chunk length
constexpr int LP = L + 1;   // padded row of the transposed tiles
constexpr int TG = 16;      // thread groups per tile axis (NT = TG * TG)
constexpr int DKMAX = 256;  // largest Dk
constexpr int KI = DKMAX / TG;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Shape {
  int b, s, h, dk, dv;
  float scale;
};

// floats of dynamic shared memory for a Dv slice of `dvb` columns
__host__ __device__ inline size_t smem_floats(int dk, int dvb) {
  return (size_t)dk * LP       // qT  [Dk][L + 1]
         + (size_t)L * (dk + 1)  // ks  [L][Dk + 1]
         + (size_t)L * dvb       // vs  [L][DVB]
         + (size_t)dk * dvb      // cs  [Dk][DVB]
         + (size_t)L * LP        // wT  [L(s)][L(t) + 1], the weighted q.k
         + dk                    // ns  [Dk]
         + 7 * L;                // per-position scalars
}

template <typename T, int DVB>
__global__ void __launch_bounds__(NT)
    mlstm_kernel(Shape sh, const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ li,
                 const float* __restrict__ lf, const float* __restrict__ c0,
                 const float* __restrict__ n0, const float* __restrict__ m0,
                 float* __restrict__ hout, float* __restrict__ c1, float* __restrict__ n1,
                 float* __restrict__ m1) {
  constexpr int VJ = DVB / TG;
  const int slice = blockIdx.x, bh = blockIdx.y;
  const int bi = bh / sh.h, hd = bh - bi * sh.h;
  const int DK = sh.dk, DV = sh.dv, H = sh.h;
  const int v0 = slice * DVB, nv = min(DVB, DV - v0);
  const int tid = threadIdx.x, tg = tid / TG, sg = tid - tg * TG;

  extern __shared__ float smem[];
  float* qT = smem;                 // qT[d * LP + t]
  float* ks = qT + DK * LP;         // ks[t * (DK + 1) + d]
  float* vs = ks + L * (DK + 1);    // vs[t * DVB + j]
  float* cs = vs + L * DVB;         // cs[d * DVB + j]
  float* wT = cs + DK * DVB;        // wT[s * LP + t]
  float* ns = wT + L * LP;          // ns[d]
  float* lis = ns + DK;             // li of the chunk
  float* bcum = lis + L;            // inclusive cumsum of lf
  float* mloc = bcum + L;           // the row stabilizer m_loc
  float* inter = mloc + L;          // exp(g - m_loc)
  float* qn = inter + L;            // q . n
  float* den = qn + L;              // the denominator
  float* sc = den + L;              // dend, then exp(dend - m_new)

  const long long qk_row = (long long)H * DK;  // one position of q / k
  const long long v_row = (long long)H * DV;   // one position of v / h
  const long long qk_base = (long long)bi * sh.s * qk_row + (long long)hd * DK;
  const long long v_base = (long long)bi * sh.s * v_row + (long long)hd * DV + v0;
  const long long g_base = (long long)bi * sh.s * H + hd;  // li / lf

  for (int i = tid; i < DK * DVB; i += NT) {
    const int d = i / DVB, j = i - d * DVB;
    cs[i] = j < nv ? c0[((long long)bh * DK + d) * DV + v0 + j] : 0.f;
  }
  for (int d = tid; d < DK; d += NT) ns[d] = n0[(long long)bh * DK + d];
  float m = m0[bh];  // the stabilizer, replicated in every thread

  for (int c0p = 0; c0p < sh.s; c0p += L) {
    const int lc = min(L, sh.s - c0p);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < L * DK; i += NT) {
      const int t = i / DK, d = i - t * DK;
      float qx = 0.f, kx = 0.f;
      if (t < lc) {
        const long long off = qk_base + (long long)(c0p + t) * qk_row + d;
        qx = to_f(q[off]);
        kx = to_f(k[off]);
      }
      qT[d * LP + t] = qx;
      ks[t * (DK + 1) + d] = kx;
    }
    for (int i = tid; i < L * DVB; i += NT) {
      const int t = i / DVB, j = i - t * DVB;
      vs[i] = (t < lc && j < nv) ? to_f(v[v_base + (long long)(c0p + t) * v_row + j]) : 0.f;
    }
    if (tid < L) {
      const long long off = g_base + (long long)(c0p + tid) * H;
      lis[tid] = tid < lc ? li[off] : 0.f;
      bcum[tid] = tid < lc ? lf[off] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // inclusive cumsum, in order
      float acc = 0.f;
      for (int t = 0; t < L; ++t) {
        acc += bcum[t];
        bcum[t] = acc;
      }
    }
    __syncthreads();
    const float btot = bcum[lc - 1];
    if (tid < lc) {
      const int t = tid;
      const float g = bcum[t] + m;
      float mx = NEG_INF;
      for (int s = 0; s <= t; ++s) mx = fmaxf(mx, bcum[t] - bcum[s] + lis[s]);
      const float ml = fmaxf(mx, g);
      mloc[t] = ml;
      inter[t] = expf(g - ml);
      sc[t] = btot - bcum[t] + lis[t];  // dend
      float acc = 0.f;
      for (int d = 0; d < DK; ++d) acc += qT[d * LP + t] * ns[d];
      qn[t] = acc;
    }
    __syncthreads();
    float m_new = btot + m;
    for (int s = 0; s < lc; ++s) m_new = fmaxf(m_new, sc[s]);
    const float decay = expf(btot + m - m_new);

    // the weighted q.k tile: rows t = tg + 16 i, columns s = sg + 16 j
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int d = 0; d < DK; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qT[d * LP + tg + TG * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ks[(sg + TG * j) * (DK + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += qv[i] * kv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tg + TG * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = sg + TG * j;
          float wqk = 0.f;
          if (s <= t && t < lc) {
            const float w = expf((bcum[t] - bcum[s] + lis[s]) - mloc[t]);
            wqk = w * (acc[i][j] * sh.scale);
          }
          wT[s * LP + t] = wqk;
        }
      }
    }
    __syncthreads();
    if (tid < lc) {  // the denominator of row t
      const int t = tid;
      float rs = 0.f;
      for (int s = 0; s < L; ++s) rs += wT[s * LP + t];
      const float den_dot = rs + inter[t] * qn[t] * sh.scale;
      den[t] = fmaxf(fabsf(den_dot), expf(-mloc[t]));
    }
    if (tid < L) sc[tid] = tid < lc ? expf(sc[tid] - m_new) : 0.f;
    __syncthreads();

    // the output tile: rows t = tg + 16 i, columns j = sg + 16 jj
    {
      float wv[4][VJ], qc[4][VJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < VJ; ++jj) wv[i][jj] = qc[i][jj] = 0.f;
      for (int s = 0; s < lc; ++s) {
        float a[4], bv[VJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = wT[s * LP + tg + TG * i];
#pragma unroll
        for (int jj = 0; jj < VJ; ++jj) bv[jj] = vs[s * DVB + sg + TG * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < VJ; ++jj) wv[i][jj] += a[i] * bv[jj];
      }
      for (int d = 0; d < DK; ++d) {
        float a[4], bv[VJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qT[d * LP + tg + TG * i];
#pragma unroll
        for (int jj = 0; jj < VJ; ++jj) bv[jj] = cs[d * DVB + sg + TG * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < VJ; ++jj) qc[i][jj] += a[i] * bv[jj];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tg + TG * i;
        if (t >= lc) continue;
#pragma unroll
        for (int jj = 0; jj < VJ; ++jj) {
          const int j = sg + TG * jj;
          if (j < nv) {
            const float num = wv[i][jj] + inter[t] * qc[i][jj] * sh.scale;
            hout[v_base + (long long)(c0p + t) * v_row + j] = num / den[t];
          }
        }
      }
    }
    __syncthreads();  // the output's readers of cs are done

    // the state to the chunk's end: C rows d = tg + 16 i, columns sg + 16 jj
    {
      float acc[KI][VJ];
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int jj = 0; jj < VJ; ++jj) acc[i][jj] = 0.f;
      for (int s = 0; s < lc; ++s) {
        const float scs = sc[s];
        float a[KI], bv[VJ];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          const int d = tg + TG * i;
          a[i] = d < DK ? scs * ks[s * (DK + 1) + d] : 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < VJ; ++jj) bv[jj] = vs[s * DVB + sg + TG * jj];
#pragma unroll
        for (int i = 0; i < KI; ++i)
#pragma unroll
          for (int jj = 0; jj < VJ; ++jj) acc[i][jj] += a[i] * bv[jj];
      }
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        const int d = tg + TG * i;
        if (d >= DK) continue;
#pragma unroll
        for (int jj = 0; jj < VJ; ++jj) {
          const int idx = d * DVB + sg + TG * jj;
          cs[idx] = decay * cs[idx] + acc[i][jj];
        }
      }
      for (int d = tid; d < DK; d += NT) {
        float nsum = 0.f;
        for (int s = 0; s < lc; ++s) nsum += sc[s] * ks[s * (DK + 1) + d];
        ns[d] = decay * ns[d] + nsum;
      }
    }
    m = m_new;
  }
  __syncthreads();
  for (int i = tid; i < DK * DVB; i += NT) {
    const int d = i / DVB, j = i - d * DVB;
    if (j < nv) c1[((long long)bh * DK + d) * DV + v0 + j] = cs[i];
  }
  if (slice == 0) {
    for (int d = tid; d < DK; d += NT) n1[(long long)bh * DK + d] = ns[d];
    if (tid == 0) m1[bh] = m;
  }
}

template <typename T, int DVB>
cudaError_t launch_dvb(const Shape& sh, const void* q, const void* k, const void* v,
                       const float* li, const float* lf, const float* c0, const float* n0,
                       const float* m0, float* h, float* c1, float* n1, float* m1,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(sh.dk, DVB);
  cudaError_t err = cudaFuncSetAttribute(mlstm_kernel<T, DVB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sh.dv + DVB - 1) / DVB, sh.b * sh.h);
  mlstm_kernel<T, DVB><<<grid, NT, smem, stream>>>(
      sh, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), li, lf,
      c0, n0, m0, h, c1, n1, m1);
  return cudaGetLastError();
}

// the widest Dv slice whose shared memory fits a block (227 KB)
constexpr size_t SMEM_MAX = 232448;

template <typename T>
cudaError_t launch(const Shape& sh, const void* q, const void* k, const void* v,
                   const float* li, const float* lf, const float* c0, const float* n0,
                   const float* m0, float* h, float* c1, float* n1, float* m1,
                   cudaStream_t stream) {
  if (sizeof(float) * smem_floats(sh.dk, 64) <= SMEM_MAX)
    return launch_dvb<T, 64>(sh, q, k, v, li, lf, c0, n0, m0, h, c1, n1, m1, stream);
  return launch_dvb<T, 32>(sh, q, k, v, li, lf, c0, n0, m0, h, c1, n1, m1, stream);
}

}  // namespace

extern "C" {

const char* mlstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The chunkwise mLSTM on `stream`. q and k are [b, s, h, dk], v [b, s, h,
// dv], float32 (bf16 == 0) or bfloat16 (bf16 != 0); li, lf [b, s, h], the
// state c0 [b, h, dk, dv], n0 [b, h, dk], m0 [b, h] and the outputs
// hout [b, s, h, dv], c1, n1, m1 (the state's shapes) float32; all
// contiguous. Returns the cudaError_t of the launch.
int mlstm_launch(int b, int s, int h, int dk, int dv, int bf16, float scale, const void* q,
                 const void* k, const void* v, const void* li, const void* lf, const void* c0,
                 const void* n0, const void* m0, void* hout, void* c1, void* n1, void* m1,
                 void* stream) {
  if (b < 1 || s < 1 || h < 1 || dk < 1 || dk > DKMAX || dv < 1 || (long long)b * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{b, s, h, dk, dv, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(li), static_cast<const float*>(lf),
                      static_cast<const float*>(c0), static_cast<const float*>(n0),
                      static_cast<const float*>(m0)};
  float* o[] = {static_cast<float*>(hout), static_cast<float*>(c1), static_cast<float*>(n1),
                static_cast<float*>(m1)};
  if (bf16)
    return static_cast<int>(launch<__nv_bfloat16>(sh, q, k, v, f[0], f[1], f[2], f[3], f[4], o[0],
                                                  o[1], o[2], o[3], st));
  return static_cast<int>(
      launch<float>(sh, q, k, v, f[0], f[1], f[2], f[3], f[4], o[0], o[1], o[2], o[3], st));
}

}  // extern "C"
