// rg_lru.cu — the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rg_lru/kernel.py: rg_lru_kernel (body _rg_lru_kernel).
// Plain version: src/repro_torch/kernels/rg_lru/ref.py (rg_lru_ref), the
//   sequential loop; the kernel does the same float operations in the same
//   order (a multiply, then an add, each rounded: the build passes
//   --fmad=false), so the two agree bitwise.
//
// What it computes. a, b [B, S, W] and h0 [B, W], all float32; h [B, S, W]
// float32 with h_0 = a_0 * h0 + b_0 and h_t = a_t * h_{t-1} + b_t. The
// recurrence is elementwise over the W channels and sequential in time.
// The TPU kernel needs S and W to be multiples of its tiles; this one takes
// any S and W.
//
// What bounds it. Bytes: two float32 loads and one store per element
// against two flops, so 12 B per element. At the hybrid prefill's shape
// (B 2, S 3072, W 2560) that is 3 x 62.9 MB, 56 us at 3.35 TB/s.
//
// Design. One thread per (batch, channel) walks time with h in a register;
// neighbouring threads take neighbouring channels, so every load and store
// of a time step is coalesced. Only B * W chains exist (5120 on the path),
// too few threads to cover the memory latency one step at a time, so each
// thread first loads U time steps of a and b into registers (2U loads in
// flight), then runs the U dependent steps and stores them. Blocks of 64
// threads spread the chains over more SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;  // threads per block
constexpr int U = 32;   // time steps loaded ahead per thread

__global__ void __launch_bounds__(NT) rg_lru_kernel(int s, int w, const float* __restrict__ a,
                                                    const float* __restrict__ b,
                                                    const float* __restrict__ h0,
                                                    float* __restrict__ h) {
  const int c = blockIdx.x * NT + threadIdx.x;
  const int bi = blockIdx.y;
  if (c >= w) return;
  const long long base = (long long)bi * s * w + c;
  float hv = h0[(long long)bi * w + c];
  for (int t0 = 0; t0 < s; t0 += U) {
    const int n = min(U, s - t0);
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n) {
        const long long off = base + (long long)(t0 + u) * w;
        av[u] = a[off];
        bv[u] = b[off];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n) {
        const float prod = av[u] * hv;  // rounded: no fused multiply-add
        hv = prod + bv[u];
        h[base + (long long)(t0 + u) * w] = hv;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* rg_lru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The recurrence on `stream`. a, b and h are [b, s, w], h0 [b, w], all
// contiguous float32. Returns the cudaError_t of the launch.
int rg_lru_launch(int b, int s, int w, const void* a, const void* bb, const void* h0, void* h,
                  void* stream) {
  if (b < 1 || s < 1 || w < 1 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((w + NT - 1) / NT, b);
  rg_lru_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      s, w, static_cast<const float*>(a), static_cast<const float*>(bb),
      static_cast<const float*>(h0), static_cast<float*>(h));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
