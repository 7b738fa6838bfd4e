// medic_gather.cu — the MeDiC block-pool gather, on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/medic_gather/kernel.py: medic_gather_kernel
//   (body _gather_kernel).
// Plain version: src/repro_torch/kernels/medic_gather/ref.py
//   (medic_gather_ref); the kernel is bitwise equal to it.
//
// What it computes. Pools p_0 .. p_{n-1}, each [N, page, H, D], of one
// shape and type, and one block table tbl [B, P] give
// out [n, B, P, page, H, D] with out[i, b, j] = p_i[tbl[b, j]]; a hole
// (tbl < 0) gives a zero page and reads nothing of the pool. Entries past
// the pool are clamped to its last page, as the reference's gather clamps.
// The copy is of bytes, so any element type is exact. One launch serves
// every pool (the engine's offload reads K and V with one).
//
// What bounds it. Bytes: each live page is read once and every output
// page written once; there is no arithmetic. At the serving path's call
// (28 pages of 16 x 8 x 128 bf16 = 32 KB each, per pool) that is under
// 2 MB a pool, well under a microsecond of HBM time: the launch and one
// round trip to device memory set the kernel's time.
//
// Design. At these sizes the kernel's time is its launch and one dependent
// pair of loads (the table entry, then the page), so the design keeps many
// loads in flight and starts every block at once. One block row per
// (pool, output page), split over blockIdx.y; each of a block's 64 threads
// moves 8 16-byte words (uint4), all 8 loads in flight before the stores,
// consecutive threads on consecutive words: 4 blocks of 8 KB per 32 KB
// page. A hole is a loop of zero stores and reads nothing. Pages whose size
// is not a multiple of 16 bytes (or a pool that is not 16-byte aligned)
// take the same loop one byte a thread. Staging pages through shared
// memory with the Tensor Memory Accelerator's bulk copies was slower at the
// path's call (one load-store round trip a block in turn; PERF.md).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxPools = 8;
constexpr int kLoopThreads = 64;
constexpr int kWords = 8;  // 16-byte words a thread
constexpr int kUnroll = 8;  // of them in flight at once

struct Pools {
  const uint8_t* p[kMaxPools];
};

// One block row per (pool, output page), split over blockIdx.y so that each
// thread moves kWords words W, consecutive threads on consecutive words; U
// of a thread's loads are in flight at once. A hole is a loop of zero
// stores and reads nothing.
template <typename W, int U>
__global__ void __launch_bounds__(kLoopThreads)
    gather_loop_kernel(Pools pools, const int* __restrict__ tbl, W* __restrict__ out, int n_pool,
                       int n_out, long long page_words) {
  const int page = blockIdx.x;  // pool * n_out + table entry
  const int pool = page / n_out;
  const int e = tbl[page - pool * n_out];
  W* dst = out + (long long)page * page_words;
  const long long step = (long long)kLoopThreads * gridDim.y;
  long long i = (long long)blockIdx.y * kLoopThreads + threadIdx.x;
  if (e < 0) {
    W z;
    uint8_t* zb = reinterpret_cast<uint8_t*>(&z);
    for (int b = 0; b < (int)sizeof(W); ++b) zb[b] = 0;
    for (; i < page_words; i += step) dst[i] = z;
    return;
  }
  const W* src =
      reinterpret_cast<const W*>(pools.p[pool]) + (long long)min(e, n_pool - 1) * page_words;
  for (; i + (U - 1) * step < page_words; i += U * step) {
    W r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) r[u] = src[i + u * step];
#pragma unroll
    for (int u = 0; u < U; ++u) dst[i + u * step] = r[u];
  }
  for (; i < page_words; i += step) dst[i] = src[i];
}

template <typename W, int U>
cudaError_t launch_loop(const Pools& pools, int n_pools, int n_pool, int n_out,
                        long long page_words, const void* tbl, void* out, cudaStream_t s) {
  long long split = page_words / ((long long)kLoopThreads * kWords);
  split = split < 1 ? 1 : (split > 16 ? 16 : split);
  dim3 grid(n_pools * n_out, (unsigned)split);
  gather_loop_kernel<W, U><<<grid, kLoopThreads, 0, s>>>(
      pools, static_cast<const int*>(tbl), static_cast<W*>(out), n_pool, n_out, page_words);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* medic_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Gather n_out pages of page_bytes each from each of n_pools pools of
// n_pool pages, on `stream`. args is a host array of int64: n_pools,
// n_pool, n_out, page_bytes, vec, then the device pointers tbl (int32
// [n_out]) and out (the n_pools outputs one after another), the stream,
// then the n_pools pool pointers; all device buffers are contiguous.
// vec != 0 promises 16-byte pages and 16-byte aligned pools and output.
// Returns the cudaError_t of the launch.
int medic_gather_launch(const void* args) {
  const long long* a = static_cast<const long long*>(args);
  const long long n_pools = a[0], n_pool = a[1], n_out = a[2], page_bytes = a[3];
  if (n_pools < 1 || n_pools > kMaxPools || n_pool < 1 || n_pool > INT_MAX || n_out < 0 ||
      n_pools * n_out > INT_MAX || page_bytes < 1 || page_bytes > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  const void* tbl = reinterpret_cast<const void*>(a[5]);
  void* out = reinterpret_cast<void*>(a[6]);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(a[7]);
  Pools p{};
  for (int i = 0; i < n_pools; ++i) p.p[i] = reinterpret_cast<const uint8_t*>(a[8 + i]);
  const int np = static_cast<int>(n_pools), nn = static_cast<int>(n_pool),
            no = static_cast<int>(n_out);
  cudaError_t e;
  if (a[4]) {
    if (page_bytes % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    e = launch_loop<uint4, kUnroll>(p, np, nn, no, page_bytes / 16, tbl, out, s);
  } else {
    e = launch_loop<uint8_t, 1>(p, np, nn, no, page_bytes, tbl, out, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
