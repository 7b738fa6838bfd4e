// tracegen.cu — trace generation's per-cell draws on Hopper: one thread a
// cell of the [S, I, W, L] trace (seed, instruction, warp, lane).
//
// Replaces no Pallas kernel: the reference samples every cell on the host in
// numpy,
//   src/repro/core/tracegen/sampler.py: _sample_cells.
// Plain version: src/repro_torch/core/tracegen/sampler.py (_sample_cells,
//   the numpy sampler); the kernel is bitwise equal to it on lines, pcs and
//   oracle_wtype. kernels/tracegen/ref.py (tracegen_model) evaluates this
//   kernel's formula on the same inputs in numpy, held against the numpy
//   sampler on the CPU.
//
// What it computes. Cell c = ((s·I + i)·W + w)·L + l of seed s has the flat
// index f = (i·W + w)·L + l and the phase ph = phase_of[i]. With the seed's
// stream keys k[s] (reuse uniform, shared uniform, pool index, working-set
// index) and splitmix64 draws bits(k, f) = mix64(k + f·GAMMA):
//     u  = (bits(k0, f) >> 11) · 2^-53                    (float64)
//     if ws_size[s,w,ph] > 0 and u < reuse[s,w,ph]:
//       if shared[s,w,ph] > 0 and u2 = uniform(k1, f) < shared[s,w,ph]:
//         line = pool[s, bits(k2, f) % pool_n]
//       else:
//         line = ((w + 1) << ws_region_bits)
//                + perm12(bits(k3, f) % ws_size, ws_key[s,w,ph])
//     else:
//       line = fresh_base + w·fresh_stride + i·L + l
// and the lane-0 thread of each (s, i, w) row writes
// pcs = pc_table[s, w, i % n_pcs] and oracle = otype[s, w, ph]. The numpy
// sampler computes every draw for every cell and selects; a draw is a pure
// function of (key, f), so drawing only the ones the branch needs gives the
// same bits. perm12 is the same pure function of (j, key) that builds the
// numpy sampler's working-set table, evaluated at the one index the cell
// draws instead of over the whole [S, W, P, 128] table.
//
// What bounds it. Integer work: at most six mix64 a cell (two 64-bit
// multiplies each) and the index arithmetic; it writes 4 bytes a cell and
// 8 a row (HAMMER16K: 67.1 MB of lines, 8.4 MB of pcs and oracle, 0.0225 ms
// at 3.35 TB/s) and reads per-warp rows that neighbouring threads share.
//
// Design. One thread a cell in a grid-stride loop of 256-thread blocks, so
// consecutive threads write consecutive lanes. The uint64 arithmetic is
// native (wrapping), the uniforms and their comparisons float64, as numpy's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint64_t kGamma = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kM1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kM2 = 0x94D049BB133111EBull;
constexpr double kInv53 = 1.0 / 9007199254740992.0;  // 2^-53
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

struct Params {
  int64_t S, I, W, L, P, n_pcs, pool_n, fresh_base, fresh_stride, ws_region_bits;
};

struct Inputs {
  const uint64_t* keys;     // [S, 4]
  const int* phase_of;      // [I]
  const int* ws_size;       // [S, W, P]
  const double* reuse;      // [S, W, P]
  const double* shared;     // [S, W, P]
  const uint64_t* ws_key;   // [S, W, P]
  const int* otype;         // [S, W, P]
  const int* pc_table;      // [S, W, n_pcs]
  const int* pool;          // [S, pool_n]
};

__device__ __forceinline__ uint64_t mix64(uint64_t z) {
  z = (z ^ (z >> 30)) * kM1;
  z = (z ^ (z >> 27)) * kM2;
  return z ^ (z >> 31);
}

__device__ __forceinline__ uint64_t bits(uint64_t key, uint64_t idx) {
  return mix64(key + idx * kGamma);
}

__device__ __forceinline__ double uniform(uint64_t key, uint64_t idx) {
  return static_cast<double>(bits(key, idx) >> 11) * kInv53;
}

// Bijection on [0, 4096) keyed by key: a 3-round 6|6 Feistel whose round
// function is one mix64 (rng.perm12).
__device__ __forceinline__ uint64_t perm12(uint64_t j, uint64_t key) {
  uint64_t left = j >> 6, right = j & 63;
  for (uint64_t rnd = 0; rnd < 3; ++rnd) {
    const uint64_t f = mix64(key + (right | (rnd << 6)) * kGamma) & 63;
    const uint64_t next = left ^ f;
    left = right;
    right = next;
  }
  return (left << 6) | right;
}

__global__ void __launch_bounds__(kThreads)
    tracegen_kernel(const Params p, const Inputs in, int* __restrict__ lines,
                    int* __restrict__ pcs, int* __restrict__ oracle) {
  const int64_t per_seed = p.I * p.W * p.L;
  const int64_t n = p.S * per_seed;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; c < n;
       c += stride) {
    const int64_t s = c / per_seed;
    const int64_t f = c - s * per_seed;  // (i·W + w)·L + l
    const int64_t row = f / p.L;         // i·W + w
    const int64_t l = f - row * p.L;
    const int64_t i = row / p.W;
    const int64_t w = row - i * p.W;
    const int ph = in.phase_of[i];
    const int64_t swp = (s * p.W + w) * p.P + ph;
    const uint64_t* k = in.keys + 4 * s;
    const uint64_t fu = static_cast<uint64_t>(f);
    const int ws = in.ws_size[swp];
    int64_t line;
    if (ws > 0 && uniform(k[0], fu) < in.reuse[swp]) {
      const double sh = in.shared[swp];
      if (sh > 0.0 && uniform(k[1], fu) < sh) {
        line = in.pool[s * p.pool_n +
                       static_cast<int64_t>(bits(k[2], fu) % static_cast<uint64_t>(p.pool_n))];
      } else {
        const uint64_t j = bits(k[3], fu) % static_cast<uint64_t>(ws);
        line = ((w + 1) << p.ws_region_bits) + static_cast<int64_t>(perm12(j, in.ws_key[swp]));
      }
    } else {
      line = p.fresh_base + w * p.fresh_stride + i * p.L + l;
    }
    lines[c] = static_cast<int>(line);
    if (l == 0) {
      const int64_t r = s * p.I * p.W + row;  // (s·I + i)·W + w
      pcs[r] = in.pc_table[(s * p.W + w) * p.n_pcs + i % p.n_pcs];
      oracle[r] = in.otype[swp];
    }
  }
}

}  // namespace

extern "C" {

const char* tracegen_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Sample every cell of an [S, I, W, L] trace on `stream`.
//   dims (host) int64[10]: S, I, W, L, P, n_pcs, pool_n, fresh_base,
//        fresh_stride, ws_region_bits;
//   ptrs (host) int64[12] device pointers, each a contiguous buffer: the
//        inputs keys u64[S, 4], phase_of i32[I], ws_size i32[S, W, P],
//        reuse f64[S, W, P], shared f64[S, W, P], ws_key u64[S, W, P],
//        otype i32[S, W, P], pc_table i32[S, W, n_pcs], pool i32[S, pool_n];
//        the outputs lines i32[S, I, W, L], pcs i32[S, I, W], oracle
//        i32[S, I, W].
// Returns the cudaError_t of the launch; cudaErrorInvalidValue for shapes
// the kernel does not take.
int tracegen_launch(const void* dims, const void* ptrs, void* stream) {
  const int64_t* d = static_cast<const int64_t*>(dims);
  const void* const* q = static_cast<const void* const*>(ptrs);
  const Params p{d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7], d[8], d[9]};
  if (p.S < 1 || p.I < 1 || p.W < 1 || p.L < 1 || p.P < 1 || p.n_pcs < 1 || p.pool_n < 1 ||
      p.fresh_base < 0 || p.fresh_stride < 0 || p.ws_region_bits < 0 || p.ws_region_bits > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  const Inputs in{(const uint64_t*)q[0], (const int*)q[1],      (const int*)q[2],
                  (const double*)q[3],   (const double*)q[4],   (const uint64_t*)q[5],
                  (const int*)q[6],      (const int*)q[7],      (const int*)q[8]};
  const int64_t n = p.S * p.I * p.W * p.L;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  tracegen_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(p, in, (int*)q[9], (int*)q[10],
                                                         (int*)q[11]);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
