// medic_gather.cu — the MeDiC block-pool gather, on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/medic_gather/kernel.py: medic_gather_kernel
//   (body _gather_kernel).
// Plain version: src/repro_torch/kernels/medic_gather/ref.py
//   (medic_gather_ref); the kernel is bitwise equal to it.
//
// What it computes. pool [N, page, H, D] and a block table tbl [B, P]
// give out [B, P, page, H, D] with out[b, j] = pool[tbl[b, j]]; a hole
// (tbl < 0) gives a zero page and reads nothing of the pool. Entries past
// the pool are clamped to its last page, as the reference's gather clamps.
// The copy is of bytes, so any element type is exact.
//
// What bounds it. Bytes: each live page is read once and every output
// page written once; there is no arithmetic. At the serving path's shape
// (28 pages of 16 x 8 x 128 bf16, 32 KB each) that is under 2 MB.
//
// Design. One block row per output page (blockIdx.x), split over
// blockIdx.y so that a few pages still spread over many SMs; each thread
// moves 16-byte words (uint4) with consecutive threads on consecutive
// words. Pages whose size is not a multiple of 16 bytes (or whose pool
// is not 16-byte aligned) take the same loop one byte at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block

template <typename W>
__global__ void __launch_bounds__(NT) medic_gather_kernel(const W* __restrict__ pool,
                                                          const int* __restrict__ tbl,
                                                          W* __restrict__ out, int n_pool,
                                                          long long page_words) {
  const int j = blockIdx.x;  // output page b * P + p
  const int e = tbl[j];
  W* dst = out + (long long)j * page_words;
  const long long step = (long long)NT * gridDim.y;
  const long long first = (long long)blockIdx.y * NT + threadIdx.x;
  if (e < 0) {
    W z;
    uint8_t* zb = reinterpret_cast<uint8_t*>(&z);
    for (int i = 0; i < (int)sizeof(W); ++i) zb[i] = 0;
    for (long long i = first; i < page_words; i += step) dst[i] = z;
    return;
  }
  const W* src = pool + (long long)min(e, n_pool - 1) * page_words;
  for (long long i = first; i < page_words; i += step) dst[i] = src[i];
}

template <typename W>
cudaError_t launch(int n_pool, int n_out, long long page_words, const void* pool,
                   const void* tbl, void* out, cudaStream_t stream) {
  // aim for about 4 words per thread, at most 16 blocks per page
  long long split = page_words / (4LL * NT);
  split = split < 1 ? 1 : (split > 16 ? 16 : split);
  dim3 grid(n_out, (unsigned)split);
  medic_gather_kernel<W><<<grid, NT, 0, stream>>>(
      static_cast<const W*>(pool), static_cast<const int*>(tbl), static_cast<W*>(out), n_pool,
      page_words);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* medic_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Gather n_out pages of page_bytes each from a pool of n_pool pages, on
// `stream`. tbl is int32 [n_out]; pool and out are contiguous device
// buffers; vec != 0 promises 16-byte pages and alignment. Returns the
// cudaError_t of the launch.
int medic_gather_launch(int n_pool, int n_out, int page_bytes, int vec, const void* pool,
                        const void* tbl, void* out, void* stream) {
  if (n_pool < 1 || n_out < 0 || page_bytes < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    if (page_bytes % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch<uint4>(n_pool, n_out, page_bytes / 16, pool, tbl, out, s));
  }
  return static_cast<int>(launch<uint8_t>(n_pool, n_out, page_bytes, pool, tbl, out, s));
}

}  // extern "C"
