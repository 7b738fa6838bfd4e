// rg_lru.cu — the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rg_lru/kernel.py: rg_lru_kernel (body _rg_lru_kernel).
// Plain version: src/repro_torch/kernels/rg_lru/ref.py (rg_lru_ref), the
//   sequential loop; the kernel does the same float operations in the same
//   order (a multiply, then an add, each rounded: __fmul_rn / __fadd_rn,
//   and the build passes --fmad=false), so the two agree bitwise.
//
// What it computes. a, b [B, S, W] and h0 [B, W], all float32; h [B, S, W]
// float32 with h_0 = a_0 * h0 + b_0 and h_t = a_t * h_{t-1} + b_t. The
// recurrence is elementwise over the W channels and sequential in time.
// The TPU kernel needs S and W to be multiples of its tiles; this one takes
// any S and W.
//
// What bounds it. Bytes: two float32 loads and one store per element
// against two flops, so 12 B per element. At the hybrid prefill's shape
// (B 2, S 3072, W 2560) that is 3 x 62.9 MB, 56 us at 3.35 TB/s. The
// dependent chain is cheap: 3072 multiply-then-add pairs a channel, ~15 us,
// so the kernel stays sequential in time and keeps the loads in flight.
//
// Design. A block is one warp; it owns kC consecutive channels of one
// batch row and walks all of S. a and b stream through a ring of kStages
// shared-memory slots, each a tile of [kT time steps x kC channels] of
// both, filled by cp.async with one commit group a tile: the copies of
// tile k + kStages - 1 are issued before tile k is consumed, so kStages - 1
// tiles are in flight while the chain runs. Lane c carries channel c's h
// in a register, reads a_t and b_t out of the slot (lane c reads bank c:
// no conflicts) and writes each h_t with a streaming store (st.global.cs;
// h is never re-read); a step's 32 stores are one coalesced 128-byte row.
// Two copy instances: V = 4 floats (16-byte cp.async.cg, for W % 4 == 0
// with 16-byte-aligned a and b) and V = 1 (4-byte cp.async.ca, any W and
// alignment). The host planner (kernels/rg_lru/ops.py: plan_rg_lru) picks
// the instance before the launch and states the tile constants below; this
// entry launches the plan as given and refuses one that differs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;       // channels a block: one 128-byte row a time step
constexpr int kT = 32;       // time steps a tile
constexpr int kStages = 4;   // tiles in the ring
constexpr int kSmem = 2 * kStages * kT * kC * 4;  // bytes: the ring of a and of b
constexpr int kDefaultSmem = 48 * 1024;           // allowed without an opt-in

__device__ __forceinline__ void copy_async(float* dst, const float* src, int bytes16) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// V floats a copy (4: 16 bytes, 1: 4 bytes). A tile row of kC floats is
// CH = kC / V copies; the warp covers RP rows a pass, lane l taking chunk
// l % CH of rows l / CH, l / CH + RP, ...
template <int V>
__global__ void __launch_bounds__(32) rg_lru_kernel(int s, int w, const float* __restrict__ a,
                                                    const float* __restrict__ b,
                                                    const float* __restrict__ h0,
                                                    float* __restrict__ h) {
  constexpr int CH = kC / V;
  constexpr int RP = 32 / CH;
  static_assert(CH * RP == 32, "a tile row's copies must divide the warp");
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;
  float* sb = smem + kStages * kT * kC;

  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kC;
  const long long row0 = (long long)blockIdx.y * s;  // row of time step 0 of this batch
  const int ntiles = (s + kT - 1) / kT;

  // this lane's copies: chunk q of rows r0, r0 + RP, ... of every tile,
  // none where the chunk lies past W (with V = 4 and W % 4 == 0 a chunk is
  // whole or out). Every call commits a group, empty or not, so that
  // group k is tile k's.
  const int q = lane % CH, r0 = lane / CH;
  const bool col_ok = c0 + q * V < w;
  auto issue = [&](int k) {  // tile k into slot k % kStages
    if (k < ntiles && col_ok) {
      const int t0 = k * kT;
      const int n = min(kT, s - t0);
      const long long off = (row0 + t0 + r0) * w + c0 + q * V;
      const float* pa = a + off;
      const float* pb = b + off;
      const int slot = (k % kStages) * kT * kC + r0 * kC + q * V;
      float* da = sa + slot;
      float* db = sb + slot;
#pragma unroll 4
      for (int r = r0; r < n; r += RP) {
        copy_async(da, pa, V == 4);
        copy_async(db, pb, V == 4);
        pa += (long long)RP * w;
        pb += (long long)RP * w;
        da += RP * kC;
        db += RP * kC;
      }
    }
    copy_commit();
  };

  for (int k = 0; k < kStages - 1; ++k) issue(k);

  const int c = c0 + lane;
  const bool mine = lane < kC && c < w;
  float hv = mine ? h0[(long long)blockIdx.y * w + c] : 0.f;
  float* po = h + row0 * w + c;
  for (int k = 0; k < ntiles; ++k) {
    // refill the slot that tile k - 1 left (every lane is past it: the
    // __syncwarp that ended the last pass), then wait for tile k's group
    issue(k + kStages - 1);
    copy_wait<kStages - 1>();
    __syncwarp();
    if (mine) {
      const int n = min(kT, s - k * kT);
      const float* ta = sa + (k % kStages) * kT * kC + lane;
      const float* tb = sb + (k % kStages) * kT * kC + lane;
#pragma unroll 8
      for (int t = 0; t < n; ++t) {
        const float prod = __fmul_rn(ta[t * kC], hv);  // rounded: no fused multiply-add
        hv = __fadd_rn(prod, tb[t * kC]);
        __stcs(po, hv);
        po += w;
      }
    }
    __syncwarp();
  }
}

template <int V>
cudaError_t launch(int b, int s, int w, const float* a, const float* bb, const float* h0,
                   float* h, cudaStream_t stream) {
  // the built ring needs no opt-in; larger tiles (tools/chip_tune_rglru.py)
  // do, and the opt-in is held per device, so it is set at each launch
  if (kSmem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        rg_lru_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((w + kC - 1) / kC, b);
  rg_lru_kernel<V><<<grid, 32, kSmem, stream>>>(s, w, a, bb, h0, h);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rg_lru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The recurrence on `stream` under the plan (vec, c, t, stages): vec 4
// (16-byte copies: w % 4 == 0, a and b 16-byte aligned) or 1 (4-byte
// copies); c, t and stages must be kC, kT and kStages, the tiles this
// source was built with. One launch of ceil(w / kC) x b warps. a, b and h
// are [b, s, w], h0 [b, w], all contiguous float32. Returns the
// cudaError_t of the launch; cudaErrorInvalidValue for a plan or shape
// outside these bounds.
int rg_lru_launch(int b, int s, int w, int vec, int c, int t, int stages, const void* a,
                  const void* bb, const void* h0, void* h, void* stream) {
  const bool shape_ok = b >= 1 && b <= 65535 && s >= 1 && w >= 1;
  const bool tiles_ok = c == kC && t == kT && stages == kStages;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(bb)) % 16 == 0;
  const bool vec_ok = vec == 1 || (vec == 4 && w % 4 == 0 && aligned);
  if (!shape_ok || !tiles_ok || !vec_ok) return static_cast<int>(cudaErrorInvalidValue);
  const float *pa = static_cast<const float*>(a), *pb = static_cast<const float*>(bb),
              *ph0 = static_cast<const float*>(h0);
  float* ph = static_cast<float*>(h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = vec == 4 ? launch<4>(b, s, w, pa, pb, ph0, ph, st)
                                 : launch<1>(b, s, w, pa, pb, ph0, ph, st);
  return static_cast<int>(e);
}

}  // extern "C"
