// mlstm.cu — the stabilized chunkwise mLSTM with its state, on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mlstm/kernel.py: mlstm_kernel (body _mlstm_kernel),
//   whose math is src/repro/models/xlstm.py: mlstm_chunkwise.
// Plain version: src/repro_torch/kernels/mlstm/ref.py (mlstm_chunkwise_ref);
//   the kernel agrees with it to rounding. Its product precision is modelled
//   in the same file (mlstm_chunkwise_tc_model), which the CPU tests hold
//   against the JAX reference.
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
// ~6 GFLOP of products: 90 us at the 67 TFLOP/s float32 rate of the CUDA
// cores, 12 us at the 495 TFLOP/s TF32 rate of the tensor cores, three
// times that for the split products below. The stabilizer chain is serial
// over chunks, and so is the state: each chunk's C update needs the last.
//
// Design. Two kernels, one launch call.
//  1. mlstm_chunk_kernel, one block per (batch, head, chunk): the terms of a
//     chunk that every Dv column shares, once. The stabilizer chain
//     m_new = max(btot + m, max(dend)) depends on the gates alone, so each
//     block runs it up to its own chunk (the gates staged in shared memory,
//     then warp 0, a warp scan a chunk) and needs nothing from the others.
//     Then m_loc, exp(g - m_loc), exp(-m_loc); q.k^T on the tensor cores;
//     the weights W = exp(d - m_loc) * q.k * scale and their row sums; sc =
//     exp(dend - m_new) and the decay. All of it goes to a scratch buffer.
//  2. mlstm_state_kernel, one block per (batch, head, slice of 32 value
//     columns), 192 blocks at the prefill's shape, two a SM: the C slice in
//     shared memory across the chunks. Per chunk: the chunk's q, k, v slice
//     and weights staged with 16-byte cp.async copies, all in flight at
//     once (zero-filled past the edges); q.n and the denominators (four
//     threads a row); then on the tensor cores W.V and q.C (the output),
//     and (k * sc)^T.V (the state update). The normalizer n, q.n and so
//     the denominators are the only chunk terms every slice computes for
//     itself: O(L * Dk) a chunk on the CUDA cores, 1/32 of a slice's
//     products, where sharing them would cost a cross-block exchange
//     every chunk. The normalizer's update sums the chunk's positions in
//     order, as the plain version does: the xLSTM float32 rerun amplifies
//     a reordered n (four partial sums there and in q.n moved its logits
//     0.014 from the plain run's, past its 1e-2; in order, 0.007).
// Products. mma.sync m16n8k8 in TF32 with float32 sums. A float32 operand is
// split into TF32 hi + lo and the product takes lo.hi + hi.lo + hi.hi
// (~21 bits of each operand; plain TF32 keeps ~11 and misses the 5e-4 /
// 5e-3 check by 50x on the CPU model). A bf16 operand is a TF32 value, so
// its lo product is skipped: at bf16 q/k/v, q.k^T takes one product and the
// others two. Shared-memory tiles are padded so that each warp's fragment
// loads hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads of either kernel (8 warps)
constexpr int L = 64;        // chunk length
constexpr int DVB = 32;      // value columns of a state block
constexpr int DKMAX = 256;   // largest Dk
constexpr int WS = L + 4;    // row stride (floats) of the weight tile
constexpr int VS = DVB + 8;  // row stride (floats) of the v and C tiles
constexpr float NEG_INF = -1e30f;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 16;   // chunks whose gates the chunk kernel stages at once

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void zero(float& x) { x = 0.f; }
__device__ __forceinline__ void zero(__nv_bfloat16& x) { x = __float2bfloat16(0.f); }

// q / k tile row padding (elements): a row stride of 8 mod 64 bf16 or 4 mod
// 32 floats keeps a fragment's eight rows on distinct banks
template <typename T>
constexpr int kPad = sizeof(T) == 2 ? 8 : 4;
// bf16 values are TF32 values: their lo part is zero
template <typename T>
constexpr bool kExact = sizeof(T) == 2;

struct Shape {
  int b, s, h, dk, dv, dkp, nc;  // dkp: Dk rounded up to 16; nc: chunks
  float scale;
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as TF32 hi + lo; an exact operand is its own hi
template <bool kEx>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = kEx ? __float_as_uint(x) : tf32(x);
  lo = kEx ? 0u : tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b from split operands: lo.hi, hi.lo, hi.hi (lo.lo dropped); the lo
// product of an exact operand is skipped
template <bool kAEx, bool kBEx>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (!kAEx) mma(d, al, bh);
  if (!kBEx) mma(d, ah, bl);
  mma(d, ah, bh);
}

// the A fragment (16 x 8, row major) of a row-major tile a[r * lda + k]
template <bool kEx, typename T>
__device__ __forceinline__ void frag_a(const T* a, int lda, int r0, int k0, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float x[4] = {to_f(a[(r0 + g) * lda + k0 + t]), to_f(a[(r0 + g + 8) * lda + k0 + t]),
                      to_f(a[(r0 + g) * lda + k0 + t + 4]),
                      to_f(a[(r0 + g + 8) * lda + k0 + t + 4])};
#pragma unroll
  for (int i = 0; i < 4; ++i) split<kEx>(x[i], hi[i], lo[i]);
}

// the B fragment (8 x 8) of a k-major tile b[k * ldb + n]
template <bool kEx, typename T>
__device__ __forceinline__ void frag_b_kn(const T* b, int ldb, int k0, int n0, uint32_t (&hi)[2],
                                          uint32_t (&lo)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  split<kEx>(to_f(b[(k0 + t) * ldb + n0 + g]), hi[0], lo[0]);
  split<kEx>(to_f(b[(k0 + t + 4) * ldb + n0 + g]), hi[1], lo[1]);
}

// the B fragment (8 x 8) of an n-major tile b[n * ldb + k]
template <bool kEx, typename T>
__device__ __forceinline__ void frag_b_nk(const T* b, int ldb, int k0, int n0, uint32_t (&hi)[2],
                                          uint32_t (&lo)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  split<kEx>(to_f(b[(n0 + g) * ldb + k0 + t]), hi[0], lo[0]);
  split<kEx>(to_f(b[(n0 + g) * ldb + k0 + t + 4]), hi[1], lo[1]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Stage a [rows][cols] tile into dst [rows][ldd]: row r of the source at
// src + r * stride; entries at rows >= nr or columns >= nc are zero. Where
// rows of nc elements are whole 16-byte words at 16-byte starts, every
// thread issues its 16-byte cp.async copies at once (zero-filled outside
// the tile); else element by element. The caller waits (cp_async_wait_all)
// and synchronizes.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ldd, const T* src, long long stride, int nr,
                                      int nc, int rows, int cols) {
  constexpr int E = 16 / sizeof(T);  // elements of a 16-byte word
  const bool vec = nc % E == 0 && cols % E == 0 && ldd % E == 0 && stride % E == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
    const int words = cols / E;
    for (int i = threadIdx.x; i < rows * words; i += NT) {
      const int r = i / words, c = (i - r * words) * E;
      const bool in = r < nr && c < nc;
      cp_async16(dst + r * ldd + c, in ? src + r * stride + c : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += NT) {
      const int r = i / cols, c = i - r * cols;
      T x;
      if (r < nr && c < nc)
        x = src[r * stride + c];
      else
        zero(x);
      dst[r * ldd + c] = x;
    }
  }
}

template <typename T>
__host__ __device__ inline size_t chunk_smem(int dkp) {
  return sizeof(float) * (L * WS + 3 * L) + sizeof(T) * 2 * L * (dkp + kPad<T>);
}

template <typename T>
__host__ __device__ inline size_t state_smem(int dkp) {
  return sizeof(float) * ((size_t)dkp * VS + L * WS + dkp + 5 * L) +
         sizeof(T) * (2 * L * (dkp + kPad<T>) + L * VS);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    mlstm_chunk_kernel(Shape sh, const T* __restrict__ q, const T* __restrict__ k,
                       const float* __restrict__ li, const float* __restrict__ lf,
                       const float* __restrict__ m0, float* __restrict__ W,
                       float* __restrict__ rows, float* __restrict__ decay,
                       float* __restrict__ m1) {
  constexpr bool EX = kExact<T>;
  const int c = blockIdx.x, bh = blockIdx.y;
  const int bi = bh / sh.h, hd = bh - bi * sh.h;
  const int ldq = sh.dkp + kPad<T>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0p = c * L, lc = min(L, sh.s - c0p);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);  // [L][WS] the weights
  float* bcum = ws + L * WS;                       // inclusive cumsum of lf
  float* lis = bcum + L;                           // li of the chunk
  float* mloc = lis + L;                           // the row stabilizer
  T* qs = reinterpret_cast<T*>(mloc + L);          // [L][ldq]
  T* ks = qs + L * ldq;                            // [L][ldq]
  __shared__ float s_mprev;
  __shared__ float gates[2][kGroup * L];  // lf, li of a group of chunks

  const long long qk_row = (long long)sh.h * sh.dk;
  const long long qk_at = (long long)bi * sh.s * qk_row + (long long)hd * sh.dk + c0p * qk_row;
  stage(qs, ldq, q + qk_at, qk_row, lc, sh.dk, L, sh.dkp);
  stage(ks, ldq, k + qk_at, qk_row, lc, sh.dk, L, sh.dkp);
  const long long chunk_id = (long long)bh * sh.nc + c;
  float* rw = rows + chunk_id * 4 * L;

  // ---- the stabilizer chain up to this chunk -------------------------------
  // the gates of up to kGroup chunks at a time into shared memory (all
  // threads), then warp 0 runs the chain over them, a warp scan a chunk
  const long long gb = (long long)bi * sh.s * sh.h + hd;  // position p at gb + p * H
  const int s0 = 2 * lane, s1 = s0 + 1;
  float m = m0[bh];
  for (int g0 = 0; g0 <= c; g0 += kGroup) {
    const int ng = min(kGroup, c + 1 - g0);
    __syncthreads();  // warp 0 is done with the previous group
    for (int i = tid; i < ng * L; i += NT) {
      const int p = g0 * L + i;
      gates[0][i] = p < sh.s ? lf[gb + (long long)p * sh.h] : 0.f;
      gates[1][i] = p < sh.s ? li[gb + (long long)p * sh.h] : 0.f;
    }
    __syncthreads();
    if (warp != 0) continue;
    for (int cc = g0; cc < g0 + ng; ++cc) {
      const int n = min(L, sh.s - cc * L), o = (cc - g0) * L;
      const float f0 = gates[0][o + s0], f1 = gates[0][o + s1];
      const float i0 = gates[1][o + s0], i1 = gates[1][o + s1];
      float incl = f0 + f1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl = y + incl;
      }
      const float y = __shfl_up_sync(kFull, incl, 1);
      const float b0 = (lane ? y : 0.f) + f0, b1 = incl;
      const float btot = __shfl_sync(kFull, ((n - 1) & 1) ? b1 : b0, (n - 1) >> 1);
      const float d0 = s0 < n ? btot - b0 + i0 : NEG_INF;
      const float d1 = s1 < n ? btot - b1 + i1 : NEG_INF;
      float dmax = fmaxf(d0, d1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dmax = fmaxf(dmax, __shfl_xor_sync(kFull, dmax, off));
      const float m_new = fmaxf(btot + m, dmax);
      if (cc == c) {  // this chunk
        bcum[s0] = b0, bcum[s1] = b1, lis[s0] = i0, lis[s1] = i1;
        rw[3 * L + s0] = s0 < n ? expf(d0 - m_new) : 0.f;
        rw[3 * L + s1] = s1 < n ? expf(d1 - m_new) : 0.f;
        if (lane == 0) {
          s_mprev = m;
          decay[chunk_id] = expf(btot + m - m_new);
          if (c == sh.nc - 1) m1[bh] = m_new;
        }
      }
      m = m_new;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- the row stabilizers --------------------------------------------------
  if (tid < L) {
    const int t = tid;
    float ml = 0.f, inter = 0.f, em = 0.f;
    if (t < lc) {
      const float g = bcum[t] + s_mprev;
      float mx = NEG_INF;
      for (int s = 0; s <= t; ++s) mx = fmaxf(mx, bcum[t] - bcum[s] + lis[s]);
      ml = fmaxf(mx, g);
      inter = expf(g - ml);
      em = expf(-ml);
    }
    mloc[t] = ml;
    rw[t] = inter;
    rw[2 * L + t] = em;
  }
  __syncthreads();

  // ---- q.k^T on the tensor cores, then the weights ---------------------------
  {
    const int mt = warp & 3, nb = (warp >> 2) * 4;  // m-tile, first of 4 n-tiles
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    for (int k0 = 0; k0 < sh.dkp; k0 += 8) {
      uint32_t ah[4], al[4];
      frag_a<EX>(qs, ldq, 16 * mt, k0, ah, al);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t bh_[2], bl_[2];
        frag_b_nk<EX>(ks, ldq, k0, 8 * (nb + i), bh_, bl_);
        mma3<EX, EX>(acc[i], ah, al, bh_, bl_);
      }
    }
    const int g = lane >> 2, tq = lane & 3;
    float* wout = W + chunk_id * L * L;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * mt + g + (e >= 2 ? 8 : 0);
        const int s = 8 * (nb + i) + 2 * tq + (e & 1);
        float wqk = 0.f;
        if (s <= t && t < lc)
          wqk = expf((bcum[t] - bcum[s] + lis[s]) - mloc[t]) * (acc[i][e] * sh.scale);
        ws[t * WS + s] = wqk;
        wout[t * L + s] = wqk;
      }
  }
  __syncthreads();
  if (tid < L) {  // the weights' row sums
    float rs = 0.f;
#pragma unroll 8
    for (int s = 0; s < L; ++s) rs += ws[tid * WS + s];
    rw[L + tid] = rs;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
    mlstm_state_kernel(Shape sh, const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ W,
                       const float* __restrict__ rows, const float* __restrict__ decay,
                       const float* __restrict__ c0, const float* __restrict__ n0,
                       float* __restrict__ hout, float* __restrict__ c1, float* __restrict__ n1) {
  constexpr bool EX = kExact<T>;
  const int slice = blockIdx.x, bh = blockIdx.y;
  const int bi = bh / sh.h, hd = bh - bi * sh.h;
  const int DK = sh.dk, DKP = sh.dkp, DV = sh.dv, ldq = DKP + kPad<T>;
  const int v0 = slice * DVB, nv = min(DVB, DV - v0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cs = reinterpret_cast<float*>(smem_raw);  // [DKP][VS] the C slice
  float* ws = cs + DKP * VS;                       // [L][WS] the weights
  float* ns = ws + L * WS;                         // [DKP] the normalizer
  float* sr = ns + DKP;                            // [4][L] the chunk's rows
  float* den = sr + 4 * L;                         // [L] the denominators
  T* qs = reinterpret_cast<T*>(den + L);           // [L][ldq]
  T* ks = qs + L * ldq;                            // [L][ldq]
  T* vs = ks + L * ldq;                            // [L][VS] v of the chunk

  for (int i = tid; i < DKP * DVB; i += NT) {
    const int d = i / DVB, j = i - d * DVB;
    cs[d * VS + j] = (d < DK && j < nv) ? c0[((long long)bh * DK + d) * DV + v0 + j] : 0.f;
  }
  for (int d = tid; d < DKP; d += NT) ns[d] = d < DK ? n0[(long long)bh * DK + d] : 0.f;

  const long long v_row = (long long)sh.h * DV, qk_row = (long long)sh.h * DK;
  const long long qk_base = (long long)bi * sh.s * qk_row + (long long)hd * DK;
  const long long v_base = (long long)bi * sh.s * v_row + (long long)hd * DV + v0;
  const int mt = warp & 3, nb = (warp >> 2) * 2;  // output: m-tile, first of 2 n-tiles
  const int nmt = DKP / 16;                        // the state's m-tiles

  for (int c = 0; c < sh.nc; ++c) {
    const int c0p = c * L, lc = min(L, sh.s - c0p);
    const long long chunk_id = (long long)bh * sh.nc + c;
    __syncthreads();  // the previous chunk is done with every tile
    if (c == 0) {  // later chunks' q and weights are staged a chunk ahead
      stage(qs, ldq, q + qk_base, qk_row, lc, DK, L, DKP);
      stage(ws, WS, W + chunk_id * L * L, L, L, L, L, L);
    }
    stage(ks, ldq, k + qk_base + c0p * qk_row, qk_row, lc, DK, L, DKP);
    stage(vs, VS, v + v_base + c0p * v_row, v_row, lc, nv, L, DVB);
    sr[tid] = rows[chunk_id * 4 * L + tid];  // NT == 4 * L
    const float dc = decay[chunk_id];
    cp_async_wait_all();
    __syncthreads();

    // q.n and the denominators, four threads a row
    {
      const int t = tid >> 2, part = tid & 3;
      float acc = 0.f;
#pragma unroll 8
      for (int d = part; d < DK; d += 4) acc += to_f(qs[t * ldq + d]) * ns[d];
      acc += __shfl_xor_sync(kFull, acc, 1);
      acc += __shfl_xor_sync(kFull, acc, 2);
      if (part == 0) den[t] = fmaxf(fabsf(sr[L + t] + sr[t] * acc * sh.scale), sr[2 * L + t]);
    }

    // W.V and q.C for rows 16 mt.., columns 8 (nb + i)..
    float a1[2][4], a2[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) a1[i][e] = a2[i][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < L; k0 += 8) {
      uint32_t ah[4], al[4];
      frag_a<false>(ws, WS, 16 * mt, k0, ah, al);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t bh_[2], bl_[2];
        frag_b_kn<EX>(vs, VS, k0, 8 * (nb + i), bh_, bl_);
        mma3<false, EX>(a1[i], ah, al, bh_, bl_);
      }
    }
#pragma unroll 4
    for (int k0 = 0; k0 < DKP; k0 += 8) {
      uint32_t ah[4], al[4];
      frag_a<EX>(qs, ldq, 16 * mt, k0, ah, al);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t bh_[2], bl_[2];
        frag_b_kn<false>(cs, VS, k0, 8 * (nb + i), bh_, bl_);
        mma3<EX, false>(a2[i], ah, al, bh_, bl_);
      }
    }
    __syncthreads();  // the denominators are in; every reader of cs, ns, qs, ws is done
    if (c + 1 < sh.nc) {  // the next chunk's q and weights, in flight from here
      const int nl = min(L, sh.s - c0p - L);
      stage(qs, ldq, q + qk_base + (c0p + L) * qk_row, qk_row, nl, DK, L, DKP);
      stage(ws, WS, W + (chunk_id + 1) * L * L, L, L, L, L, L);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * mt + g + (e >= 2 ? 8 : 0);
        const int j = 8 * (nb + i) + 2 * tq + (e & 1);
        if (t < lc && j < nv)
          hout[v_base + (long long)(c0p + t) * v_row + j] =
              (a1[i][e] + sr[t] * a2[i][e] * sh.scale) / den[t];
      }

    // the state update (k * sc)^T.V: rows in m-tiles warp and warp + 8, all
    // four n-tiles
    {
      float a3[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) a3[mi][i][e] = 0.f;
#pragma unroll 2
      for (int k0 = 0; k0 < L; k0 += 8) {
        uint32_t bh_[4][2], bl_[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) frag_b_kn<EX>(vs, VS, k0, 8 * i, bh_[i], bl_[i]);
        const float sc0 = sr[3 * L + k0 + tq], sc1 = sr[3 * L + k0 + tq + 4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int m0t = warp + 8 * mi;
          if (m0t >= nmt) continue;
          const int d0 = 16 * m0t + g;
          const float x[4] = {to_f(ks[(k0 + tq) * ldq + d0]) * sc0,
                              to_f(ks[(k0 + tq) * ldq + d0 + 8]) * sc0,
                              to_f(ks[(k0 + tq + 4) * ldq + d0]) * sc1,
                              to_f(ks[(k0 + tq + 4) * ldq + d0 + 8]) * sc1};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split<false>(x[e], ah[e], al[e]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma3<false, EX>(a3[mi][i], ah, al, bh_[i], bl_[i]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m0t = warp + 8 * mi;
        if (m0t >= nmt) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 16 * m0t + g + (e >= 2 ? 8 : 0);
            const int j = 8 * i + 2 * tq + (e & 1);
            cs[d * VS + j] = dc * cs[d * VS + j] + a3[mi][i][e];
          }
      }
    }
    for (int d = tid; d < DK; d += NT) {
      float acc = 0.f;
#pragma unroll 8
      for (int s = 0; s < lc; ++s) acc += sr[3 * L + s] * to_f(ks[s * ldq + d]);
      ns[d] = dc * ns[d] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < DK * DVB; i += NT) {
    const int d = i / DVB, j = i - d * DVB;
    if (j < nv) c1[((long long)bh * DK + d) * DV + v0 + j] = cs[d * VS + j];
  }
  if (slice == 0)
    for (int d = tid; d < DK; d += NT) n1[(long long)bh * DK + d] = ns[d];
}

// raise a kernel's dynamic shared memory limit once per device and size
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || smem <= 48 * 1024 || (dev < kMaxDevices && smem <= allowed[dev]))
    return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return e;
}

template <typename T>
cudaError_t launch(const Shape& sh, const void* q, const void* k, const void* v,
                   const float* li, const float* lf, const float* c0, const float* n0,
                   const float* m0, float* h, float* c1, float* n1, float* m1, float* scratch,
                   cudaStream_t stream) {
  static size_t allowed_chunk[kMaxDevices] = {}, allowed_state[kMaxDevices] = {};
  const size_t s1 = chunk_smem<T>(sh.dkp), s2 = state_smem<T>(sh.dkp);
  cudaError_t e = allow_smem(mlstm_chunk_kernel<T>, s1, allowed_chunk);
  if (e == cudaSuccess) e = allow_smem(mlstm_state_kernel<T>, s2, allowed_state);
  if (e != cudaSuccess) return e;
  const int bh = sh.b * sh.h;
  float* W = scratch;
  float* rows = W + (size_t)bh * sh.nc * L * L;
  float* decay = rows + (size_t)bh * sh.nc * 4 * L;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  mlstm_chunk_kernel<T><<<dim3(sh.nc, bh), NT, s1, stream>>>(sh, qt, kt, li, lf, m0, W, rows,
                                                             decay, m1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mlstm_state_kernel<T><<<dim3((sh.dv + DVB - 1) / DVB, bh), NT, s2, stream>>>(
      sh, qt, kt, static_cast<const T*>(v), W, rows, decay, c0, n0, h, c1, n1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mlstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The chunkwise mLSTM on `stream`. q and k are [b, s, h, dk], v [b, s, h,
// dv], float32 (bf16 == 0) or bfloat16 (bf16 != 0); li, lf [b, s, h], the
// state c0 [b, h, dk, dv], n0 [b, h, dk], m0 [b, h] and the outputs
// hout [b, s, h, dv], c1, n1, m1 (the state's shapes) float32; scratch
// float32 of b * h * ceil(s / 64) * (64 * 64 + 4 * 64 + 1) elements; all
// contiguous. Returns the cudaError_t of the launches.
int mlstm_launch(int b, int s, int h, int dk, int dv, int bf16, float scale, const void* q,
                 const void* k, const void* v, const void* li, const void* lf, const void* c0,
                 const void* n0, const void* m0, void* hout, void* c1, void* n1, void* m1,
                 void* scratch, void* stream) {
  if (b < 1 || s < 1 || h < 1 || dk < 1 || dk > DKMAX || dv < 1 || (long long)b * h > 65535 ||
      (s + L - 1) / L > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{b, s, h, dk, dv, (dk + 15) / 16 * 16, (s + L - 1) / L, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(li), static_cast<const float*>(lf),
                      static_cast<const float*>(c0), static_cast<const float*>(n0),
                      static_cast<const float*>(m0)};
  float* o[] = {static_cast<float*>(hout), static_cast<float*>(c1), static_cast<float*>(n1),
                static_cast<float*>(m1), static_cast<float*>(scratch)};
  if (bf16)
    return static_cast<int>(launch<__nv_bfloat16>(sh, q, k, v, f[0], f[1], f[2], f[3], f[4],
                                                  o[0], o[1], o[2], o[3], o[4], st));
  return static_cast<int>(launch<float>(sh, q, k, v, f[0], f[1], f[2], f[3], f[4], o[0], o[1],
                                        o[2], o[3], o[4], st));
}

}  // extern "C"
