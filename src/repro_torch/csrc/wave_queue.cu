// wave_queue.cu — the wavefront engine's timing pass for one wave, on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/wavefront_scan/kernel.py: wave_queue_kernel
//   (body _queue_kernel), plus the carry advance the reference runs after it
//   (src/repro/kernels/wavefront_scan/ops.py: _carry_epilogue).
// Plain version: src/repro_torch/kernels/wavefront_scan/ref.py
//   (wave_queue_recovery_ref); the kernel is bitwise equal to it.
//
// What it computes. N requests in warp-major chronological order go through
// three families of FIFO queues: the L2 banks, then per DRAM channel a
// strict-priority pair (HP before LP) with a row-buffer predecessor chain.
// For request j of queue q,
//     start_j = c_j + max_{i<=j, i in q} (max(t_i, floor_i) - c_i)
// with c the exclusive prefix occupancy of q. The kernel computes exactly
// these float operations on exactly these values — v = max(t, floor) - c,
// start = c + runmax(v) — and never the sequential max(t, prev_end)
// recurrence, which rounds differently on non-dyadic times. Occupancies are
// integer-valued (checked by the wrapper), so every prefix sum is exact in
// any order and the block-level scans below reproduce the reference bit for
// bit; max is exactly associative.
//
// What bounds it. The work is tiny (N <= 16384 slots, ~40 B each: under
// 1 MB moved) and a chain of dependent scans: bank -> t_head -> t_da -> row
// chain -> HP -> HP busy horizon -> LP. It is latency-bound, not bandwidth-
// or compute-bound: one wave is one block, and the time is the number of
// dependent scan steps times the cost of a block barrier.
//
// Design. One thread block of NT threads walks the N slots in chunks of NT,
// one slot per thread. For each queue family it runs a block-level scan over
// a QMAX-wide vector (one entry per queue; a slot contributes only to its own
// queue): warp shuffles, then one shared-memory pass over the warp totals.
// Across chunks it carries, per queue, the prefix occupancy, the running max,
// the last go-to-DRAM slot (the open row) and the HP busy horizon. The carry
// advance of the next wave (busy-until horizons, service-frontier anchors,
// open rows) is fused: an epilogue pass reduces each field by max over the
// block, so one launch returns (t_head, t0, row_hit, new carry).
//
// Row and channel indices arrive precomputed from the wrapper (floor division
// of the line address, as in the reference: -1 // 32 == -1).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define QMAX 8    // most banks or channels one launch takes
#define NT 512    // threads per block (one slot each per chunk)

namespace {

struct Add {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// a[q] for a runtime q without dynamic register indexing
__device__ __forceinline__ float pick(const float (&a)[QMAX], int q) {
  float r = a[0];
#pragma unroll
  for (int k = 1; k < QMAX; ++k)
    if (k == q) r = a[k];
  return r;
}

// Block-wide inclusive scan of x[QMAX] (one independent scan per queue).
// On return x holds the inclusive and ex the exclusive scan at this thread;
// the return value, in thread q < QMAX, is queue q's chunk total.
template <class Op>
__device__ __forceinline__ float block_scan(float (&x)[QMAX], float (&ex)[QMAX],
                                            float ident, Op op, float (*sh)[QMAX]) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int q = 0; q < QMAX; ++q) {
      const float y = __shfl_up_sync(0xffffffffu, x[q], off);
      if (lane >= off) x[q] = op(y, x[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < QMAX; ++q) {
    const float y = __shfl_up_sync(0xffffffffu, x[q], 1);
    ex[q] = lane ? y : ident;
  }
  if (lane == 31) {
#pragma unroll
    for (int q = 0; q < QMAX; ++q) sh[wid][q] = x[q];
  }
  __syncthreads();
  float pre[QMAX];
#pragma unroll
  for (int q = 0; q < QMAX; ++q) pre[q] = ident;
  for (int w = 0; w < wid; ++w) {
#pragma unroll
    for (int q = 0; q < QMAX; ++q) pre[q] = op(pre[q], sh[w][q]);
  }
#pragma unroll
  for (int q = 0; q < QMAX; ++q) {
    x[q] = op(pre[q], x[q]);
    ex[q] = op(pre[q], ex[q]);
  }
  float tot = ident;
  if (threadIdx.x < QMAX)
    for (int w = 0; w < nw; ++w) tot = op(tot, sh[w][threadIdx.x]);
  __syncthreads();
  return tot;
}

// Block max of acc[2*QMAX]; thread k < 2*QMAX receives entry k's maximum.
__device__ __forceinline__ float block_max2(float (&acc)[2 * QMAX], float (*sh)[2 * QMAX]) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < 2 * QMAX; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] = fmaxf(acc[k], __shfl_xor_sync(0xffffffffu, acc[k], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 2 * QMAX; ++k) sh[wid][k] = acc[k];
  }
  __syncthreads();
  float r = -INFINITY;
  if (threadIdx.x < 2 * QMAX)
    for (int w = 0; w < nw; ++w) r = fmaxf(r, sh[w][threadIdx.x]);
  __syncthreads();
  return r;
}

// Work-conserving carry floor at one slot (ref.carry_floor at the slot's own
// queue): the busy-until for a request at/after the queue's serviced frontier,
// else the standing backlog anchored at its service arrival. -inf anchors give
// a +inf backlog, hence the plain busy-until; no NaN arises.
__device__ __forceinline__ float carry_floor(int exact, float f, float last_ts, float last_sa,
                                             float t_s, float t_svc) {
  if (exact) return f;
  const float interp = fminf(f, t_svc + (f - last_sa));
  return t_s >= last_ts ? f : interp;
}

struct Params {
  int n, banks, channels, exact;
  float l2_svc, l2_lat, occ_rowhit, occ_rowmiss;
};

struct Carry {  // one pointer per QueueCarry field
  const float *bank_free, *bank_ts, *hp_free, *hp_ts, *hp_sa, *lp_free, *lp_ts, *lp_sa;
  const int* cur_row;
};

struct CarryOut {
  float *bank_free, *bank_ts, *hp_free, *hp_ts, *hp_sa, *lp_free, *lp_ts, *lp_sa;
  int* cur_row;
};

__global__ void __launch_bounds__(NT) wave_queue_kernel(
    Params p, const float* __restrict__ t_s, const int* __restrict__ bank,
    const uint8_t* __restrict__ use_l2, const int* __restrict__ ch, const int* __restrict__ row,
    const uint8_t* __restrict__ go_dram, const uint8_t* __restrict__ byp,
    const uint8_t* __restrict__ hp, Carry cin, float* t_head_out, float* t0_out,
    uint8_t* row_hit_out, CarryOut cout) {
  __shared__ float sh[32][QMAX];
  __shared__ float sh2[32][2 * QMAX];
  // carried-in queue state, for per-slot lookups
  __shared__ float s_bfree[QMAX], s_bts[QMAX], s_hfree[QMAX], s_hts[QMAX], s_hsa[QMAX],
      s_lfree[QMAX], s_lts[QMAX], s_lsa[QMAX];
  __shared__ int s_row[QMAX];
  // across-chunk scan carries, per queue
  __shared__ float k_bsum[QMAX], k_bmax[QMAX], k_last[QMAX], k_hsum[QMAX], k_hmax[QMAX],
      k_busy[QMAX], k_lsum[QMAX], k_lmax[QMAX];

  const int tid = threadIdx.x;
  if (tid < QMAX) {
    const bool b = tid < p.banks, c = tid < p.channels;
    s_bfree[tid] = b ? cin.bank_free[tid] : 0.f;
    s_bts[tid] = b ? cin.bank_ts[tid] : 0.f;
    s_hfree[tid] = c ? cin.hp_free[tid] : 0.f;
    s_hts[tid] = c ? cin.hp_ts[tid] : 0.f;
    s_hsa[tid] = c ? cin.hp_sa[tid] : 0.f;
    s_lfree[tid] = c ? cin.lp_free[tid] : 0.f;
    s_lts[tid] = c ? cin.lp_ts[tid] : 0.f;
    s_lsa[tid] = c ? cin.lp_sa[tid] : 0.f;
    s_row[tid] = c ? cin.cur_row[tid] : -1;
    k_bsum[tid] = 0.f;
    k_bmax[tid] = -INFINITY;
    k_last[tid] = -1.f;
    k_hsum[tid] = 0.f;
    k_hmax[tid] = -INFINITY;
    k_busy[tid] = -INFINITY;
    k_lsum[tid] = 0.f;
    k_lmax[tid] = -INFINITY;
  }
  __syncthreads();

  float x[QMAX], ex[QMAX];
  for (int base = 0; base < p.n; base += NT) {
    const int j = base + tid;
    const bool in = j < p.n;
    const float ts = in ? t_s[j] : 0.f;
    const int qb = in ? bank[j] : 0;
    const int qc = in ? ch[j] : 0;
    const bool ul2 = in && use_l2[j];
    const bool gd = in && go_dram[j];
    const bool hpj = in && hp[j];
    const bool bypj = in && byp[j];

    // ---- L2 bank queues ---------------------------------------------------
    const float cb = k_bsum[qb], mb = k_bmax[qb];
#pragma unroll
    for (int q = 0; q < QMAX; ++q) x[q] = (ul2 && q == qb) ? p.l2_svc : 0.f;
    const float t_bs = block_scan(x, ex, 0.f, Add(), sh);
    const float c_b = cb + pick(ex, qb);
    const float f_b = carry_floor(p.exact, s_bfree[qb], s_bts[qb], s_bts[qb], ts, ts);
    const float v_b = ul2 ? fmaxf(ts, f_b) - c_b : -INFINITY;
#pragma unroll
    for (int q = 0; q < QMAX; ++q) x[q] = (q == qb) ? v_b : -INFINITY;
    const float t_bm = block_scan(x, ex, -INFINITY, Max(), sh);
    const float b_start = c_b + fmaxf(mb, pick(x, qb));
    const float t_head = ul2 ? 0.f + b_start : 0.f;

    // ---- DRAM row-buffer chain: previous go-to-DRAM slot of the channel ----
    const float t_da = bypj ? ts : t_head + p.l2_lat;
    const float last = k_last[qc];
#pragma unroll
    for (int q = 0; q < QMAX; ++q) x[q] = (gd && q == qc) ? (float)j : -1.f;
    const float t_rw = block_scan(x, ex, -1.f, Max(), sh);
    const int prev = (int)fmaxf(last, pick(ex, qc));
    const int prev_row = prev >= 0 ? row[prev] : s_row[qc];
    const int rowj = in ? row[j] : 0;
    const bool rh = gd && prev_row == rowj;
    const float occ = rh ? p.occ_rowhit : p.occ_rowmiss;

    // ---- high-priority queue ----------------------------------------------
    const bool mhp = gd && hpj;
    const float ch_ = k_hsum[qc], mh = k_hmax[qc], busy0 = k_busy[qc];
#pragma unroll
    for (int q = 0; q < QMAX; ++q) x[q] = (mhp && q == qc) ? occ : 0.f;
    const float t_hs = block_scan(x, ex, 0.f, Add(), sh);
    const float c_h = ch_ + pick(ex, qc);
    const float f_hp = carry_floor(p.exact, s_hfree[qc], s_hts[qc], s_hsa[qc], ts, t_da);
    const float v_h = mhp ? fmaxf(t_da, f_hp) - c_h : -INFINITY;
#pragma unroll
    for (int q = 0; q < QMAX; ++q) x[q] = (q == qc) ? v_h : -INFINITY;
    const float t_hm = block_scan(x, ex, -INFINITY, Max(), sh);
    const float hp_start = c_h + fmaxf(mh, pick(x, qc));
    const float hp_end = mhp ? hp_start + occ : -INFINITY;

    // strict priority: the HP busy horizon before this slot, per channel
#pragma unroll
    for (int q = 0; q < QMAX; ++q) x[q] = (q == qc) ? hp_end : -INFINITY;
    const float t_bz = block_scan(x, ex, -INFINITY, Max(), sh);
    const float hp_busy = fmaxf(busy0, pick(ex, qc));

    // ---- low-priority queue -----------------------------------------------
    const bool mlp = gd && !hpj;
    const float cl = k_lsum[qc], ml = k_lmax[qc];
    const float f_lp = carry_floor(p.exact, s_lfree[qc], s_lts[qc], s_lsa[qc], ts, t_da);
    const float lp_floor = fmaxf(f_lp, fmaxf(f_hp, hp_busy));
#pragma unroll
    for (int q = 0; q < QMAX; ++q) x[q] = (mlp && q == qc) ? occ : 0.f;
    const float t_ls = block_scan(x, ex, 0.f, Add(), sh);
    const float c_l = cl + pick(ex, qc);
    const float v_l = mlp ? fmaxf(t_da, lp_floor) - c_l : -INFINITY;
#pragma unroll
    for (int q = 0; q < QMAX; ++q) x[q] = (q == qc) ? v_l : -INFINITY;
    const float t_lm = block_scan(x, ex, -INFINITY, Max(), sh);
    const float lp_start = c_l + fmaxf(ml, pick(x, qc));

    if (in) {
      t_head_out[j] = t_head;
      t0_out[j] = hpj ? hp_start : lp_start;
      row_hit_out[j] = rh ? 1 : 0;
    }
    // advance the across-chunk carries (every thread read them above,
    // before the scans' barriers)
    if (tid < QMAX) {
      k_bsum[tid] += t_bs;
      k_bmax[tid] = fmaxf(k_bmax[tid], t_bm);
      k_last[tid] = fmaxf(k_last[tid], t_rw);
      k_hsum[tid] += t_hs;
      k_hmax[tid] = fmaxf(k_hmax[tid], t_hm);
      k_busy[tid] = fmaxf(k_busy[tid], t_bz);
      k_lsum[tid] += t_ls;
      k_lmax[tid] = fmaxf(k_lmax[tid], t_lm);
    }
    __syncthreads();
  }

  // ---- fused carry advance: per-queue max reductions over the wave -------
  // Each thread re-reads only the slots it wrote itself.
  float acc[2 * QMAX];
  for (int pass = 0; pass < 4; ++pass) {
#pragma unroll
    for (int k = 0; k < 2 * QMAX; ++k) acc[k] = -INFINITY;
    for (int j = tid; j < p.n; j += NT) {
      const bool ul2 = use_l2[j], gd = go_dram[j], hpj = hp[j];
      const float ts = t_s[j], th = t_head_out[j];
      const float t_da = byp[j] ? ts : th + p.l2_lat;
      const float end = t0_out[j] + (row_hit_out[j] ? p.occ_rowhit : p.occ_rowmiss);
      const int qb = bank[j], qc = ch[j];
      float a = -INFINITY, b = -INFINITY;
      int qa = -1;
      if (pass == 0 && ul2) { qa = qb; a = th + p.l2_svc; b = ts; }
      if (pass == 1 && gd && hpj) { qa = qc; a = end; b = ts; }
      if (pass == 2 && gd) { qa = qc; a = hpj ? t_da : -INFINITY; b = hpj ? -INFINITY : end; }
      if (pass == 3 && gd && !hpj) { qa = qc; a = ts; b = t_da; }
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        if (q == qa) {
          acc[q] = fmaxf(acc[q], a);
          acc[QMAX + q] = fmaxf(acc[QMAX + q], b);
        }
      }
    }
    const float r = block_max2(acc, sh2);
    if (tid < 2 * QMAX) {
      const int q = tid % QMAX;
      const bool second = tid >= QMAX;
      if (pass == 0 && q < p.banks) {
        if (!second) cout.bank_free[q] = fmaxf(s_bfree[q], r);
        else cout.bank_ts[q] = fmaxf(s_bts[q], r);
      }
      if (pass == 1 && q < p.channels) {
        if (!second) cout.hp_free[q] = fmaxf(s_hfree[q], r);
        else cout.hp_ts[q] = fmaxf(s_hts[q], r);
      }
      if (pass == 2 && q < p.channels) {
        if (!second) cout.hp_sa[q] = fmaxf(s_hsa[q], r);
        else cout.lp_free[q] = fmaxf(s_lfree[q], r);
      }
      if (pass == 3 && q < p.channels) {
        if (!second) cout.lp_ts[q] = fmaxf(s_lts[q], r);
        else cout.lp_sa[q] = fmaxf(s_lsa[q], r);
      }
    }
  }
  if (tid < p.channels) {
    const int last = (int)k_last[tid];
    cout.cur_row[tid] = last >= 0 ? row[last] : s_row[tid];
  }
}

}  // namespace

extern "C" {

const char* wave_queue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch one wave's timing pass on `stream`. Every pointer is a contiguous
// device buffer: slots [n] (bool as one byte), carry fields [banks] or
// [channels]. Returns the cudaError_t of the launch.
int wave_queue_launch(int n, int banks, int channels, int exact, float l2_svc, float l2_lat,
                      float occ_rowhit, float occ_rowmiss, const void* t_s, const void* bank,
                      const void* use_l2, const void* ch, const void* row, const void* go_dram,
                      const void* byp, const void* hp, const void* bank_free,
                      const void* bank_ts, const void* hp_free, const void* hp_ts,
                      const void* hp_sa, const void* lp_free, const void* lp_ts,
                      const void* lp_sa, const void* cur_row, void* t_head, void* t0,
                      void* row_hit, void* o_bank_free, void* o_bank_ts, void* o_hp_free,
                      void* o_hp_ts, void* o_hp_sa, void* o_lp_free, void* o_lp_ts,
                      void* o_lp_sa, void* o_cur_row, void* stream) {
  if (banks > QMAX || channels > QMAX || banks < 1 || channels < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{n, banks, channels, exact, l2_svc, l2_lat, occ_rowhit, occ_rowmiss};
  Carry cin{(const float*)bank_free, (const float*)bank_ts, (const float*)hp_free,
            (const float*)hp_ts,     (const float*)hp_sa,   (const float*)lp_free,
            (const float*)lp_ts,     (const float*)lp_sa,   (const int*)cur_row};
  CarryOut cout{(float*)o_bank_free, (float*)o_bank_ts, (float*)o_hp_free,
                (float*)o_hp_ts,     (float*)o_hp_sa,   (float*)o_lp_free,
                (float*)o_lp_ts,     (float*)o_lp_sa,   (int*)o_cur_row};
  wave_queue_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      p, (const float*)t_s, (const int*)bank, (const uint8_t*)use_l2, (const int*)ch,
      (const int*)row, (const uint8_t*)go_dram, (const uint8_t*)byp, (const uint8_t*)hp, cin,
      (float*)t_head, (float*)t0, (uint8_t*)row_hit, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
