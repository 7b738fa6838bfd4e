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
// any order and any blocking of the scans reproduces the reference bit for
// bit; max is exactly associative.
//
// What bounds it. The work is tiny (N = B * L slots, ~40 B each: 0.3 MB at
// N 8192) and a chain of dependent scans: bank occupancy -> bank start ->
// t_da, row chain -> HP and LP occupancy -> HP start -> HP busy horizon ->
// LP start. It is latency-bound: its time is the number of dependent
// cluster-wide steps times their cost, plus each thread's serial walk over
// its own slots.
//
// Design. One thread-block cluster of up to 8 blocks (one SM each) of T
// threads; each thread owns K consecutive slots (the blocks, T and K from
// the host's plan: plan_wave_queue in kernels/wavefront_scan/ops.py; one
// pass covers up to 8 * 512 * 16 slots). The queue families are fused into
// five dependent stages; each is one pass of the thread over its own slots
// and one cluster-wide scan of the thread's per-queue partials (QMAX wide
// per family: warp shuffles, warp 0 over the warp totals, then the blocks'
// totals through distributed shared memory at one cluster barrier):
//   S1 bank occupancy (+) and the row chain's last DRAM slot (max);
//   S2 bank start (max), HP and LP occupancy (+);
//   S3 HP start (max);  S4 HP busy horizon (max);  S5 LP start (max).
// Each pass applies the previous stage's prefix slot by slot (a running
// per-queue value in registers) and builds the next stage's partials, so a
// pass costs five scans whatever N, not one per 512-slot chunk. Each block
// first copies its slots into shared memory with coalesced loads (a
// thread's own slots are K apart from its neighbours'); there a slot keeps
// a packed word (bank, channel, flags, row hit), t_s, its row (then c_h or
// c_l, then hp_end) and one more float (c_b, then t_da or v_l), in [K][T+1]
// arrays so that both the copy and a warp's per-slot accesses spread over
// the banks. Above one pass the cluster walks the wave in passes, each scan
// carrying its per-queue totals to the next. The carry advance of the next
// wave (busy-until horizons, service-frontier anchors) is folded into the
// passes that compute its terms: each warp reduces its per-queue maxima
// with one __reduce_max_sync on order-preserving integer keys, lane 0 folds
// them into its block's shared memory with atomicMax, and block 0 takes the
// maximum over the blocks; the open rows come from the row chain's carry.
// One launch returns (t_head, t0, row_hit, new carry).
//
// Row and channel indices arrive precomputed from the wrapper (floor division
// of the line address, as in the reference: -1 // 32 == -1).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

#define QMAX 8  // most banks or channels one launch takes

namespace {

constexpr int kMaxBlocks = 8;     // blocks of the cluster (the portable most)
constexpr int kMaxThreads = 512;  // threads of a block
constexpr int kMaxK = 16;         // slots a thread
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxW = 3 * QMAX;   // widest scan (S2)
constexpr int kMaxDevices = 64;

// the packed slot word in shared memory
constexpr int kUl2 = 1 << 8, kGd = 1 << 9, kHp = 1 << 10, kByp = 1 << 11, kRh = 1 << 12;

// a[q] for a runtime q < QMAX without dynamic register indexing: a tree of
// selects, three deep
__device__ __forceinline__ float pick(const float (&a)[QMAX], int q) {
  const bool b0 = q & 1, b1 = q & 2, b2 = q & 4;
  const float x0 = b0 ? a[1] : a[0], x1 = b0 ? a[3] : a[2], x2 = b0 ? a[5] : a[4],
              x3 = b0 ? a[7] : a[6];
  const float y0 = b1 ? x1 : x0, y1 = b1 ? x3 : x2;
  return b2 ? y1 : y0;
}

__device__ __forceinline__ void put(float (&a)[QMAX], int q, float v) {
#pragma unroll
  for (int k = 0; k < QMAX; ++k)
    if (k == q) a[k] = v;
}

__device__ __forceinline__ void add_at(float (&a)[QMAX], int q, float v) {
#pragma unroll
  for (int k = 0; k < QMAX; ++k)
    if (k == q) a[k] = a[k] + v;
}

__device__ __forceinline__ void max_at(float (&a)[QMAX], int q, float v) {
#pragma unroll
  for (int k = 0; k < QMAX; ++k)
    if (k == q) a[k] = fmaxf(a[k], v);
}

__device__ __forceinline__ void fill(float (&a)[QMAX], float v) {
#pragma unroll
  for (int k = 0; k < QMAX; ++k) a[k] = v;
}

// order-preserving int key of a float (no NaN here): a < b iff key(a) < key(b)
__device__ __forceinline__ int fkey(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float funkey(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// the shared-memory scratch of the scans
struct ScanMem {
  float tot[kMaxWarps][kMaxW];  // the warps' totals, then their prefixes
  float btot[2][kMaxW];         // the block's totals, by the scans' parity
  float pre[kMaxW];             // the earlier blocks' and passes' totals
};

// Cluster-wide exclusive scan of W per-queue entries, one independent scan
// per entry: entries [0, NA) by +, the rest by max. In: this thread's totals
// over its slots. Out: the combined totals of every earlier thread of this
// block and of every thread of the cluster's lower-ranked blocks, with
// `carry` (the totals of the earlier passes, in shared memory, the same in
// every block) folded in; `carry` advances by the pass's total. The blocks
// exchange their totals through distributed shared memory, at one cluster
// barrier a scan (the totals alternate between two buffers, so the next
// scan's writes cannot meet this one's reads).
template <int NA, int W>
__device__ __forceinline__ void block_scan(float (&x)[W], float* carry, ScanMem& m, int& par,
                                           cg::cluster_group& cl) {
  float (*tot)[kMaxW] = m.tot;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float y = __shfl_up_sync(0xffffffffu, x[e], off);
      if (lane >= off) x[e] = e < NA ? y + x[e] : fmaxf(y, x[e]);
    }
  }
  float ex[W];
#pragma unroll
  for (int e = 0; e < W; ++e) {
    const float y = __shfl_up_sync(0xffffffffu, x[e], 1);
    ex[e] = lane ? y : (e < NA ? 0.f : -INFINITY);
  }
  __syncwarp();  // this warp's readers of the previous scan's prefixes are done
  if (lane == 31) {
#pragma unroll
    for (int e = 0; e < W; ++e) tot[wid][e] = x[e];
  }
  __syncthreads();
  if (wid == 0) {  // warp 0 scans the warp totals, all entries at once
    float v[W];
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = lane < nw ? tot[lane][e] : (e < NA ? 0.f : -INFINITY);
#pragma unroll
    for (int off = 1; off < kMaxWarps; off <<= 1) {
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float y = __shfl_up_sync(0xffffffffu, v[e], off);
        if (lane >= off) v[e] = e < NA ? y + v[e] : fmaxf(y, v[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float y = __shfl_up_sync(0xffffffffu, v[e], 1);
      const float total = __shfl_sync(0xffffffffu, v[e], nw - 1);
      if (lane < nw) tot[lane][e] = lane ? y : (e < NA ? 0.f : -INFINITY);
      if (lane == 0) m.btot[par][e] = total;
    }
  }
  cl.sync();  // every block's totals are in
  if (wid == 0 && lane < W) {  // lane e: entry e over the blocks
    const bool add = lane < NA;
    const int rank = static_cast<int>(cl.block_rank()), nb = static_cast<int>(cl.num_blocks());
    float before = add ? 0.f : -INFINITY, all = before, b[kMaxBlocks];
#pragma unroll
    for (int r = 0; r < kMaxBlocks; ++r)  // every remote load in flight at once
      b[r] = r < nb ? cl.map_shared_rank(m.btot[par], r)[lane] : before;
#pragma unroll
    for (int r = 0; r < kMaxBlocks; ++r) {
      if (r < rank) before = add ? before + b[r] : fmaxf(before, b[r]);
      all = add ? all + b[r] : fmaxf(all, b[r]);
    }
    const float c = carry[lane];
    m.pre[lane] = add ? c + before : fmaxf(c, before);
    carry[lane] = add ? c + all : fmaxf(c, all);
  }
  par ^= 1;
  __syncthreads();
#pragma unroll
  for (int e = 0; e < W; ++e)
    x[e] = e < NA ? (m.pre[e] + tot[wid][e]) + ex[e]
                  : fmaxf(fmaxf(m.pre[e], tot[wid][e]), ex[e]);
}

// the warp's maxima of v[q] into out[q] (int keys in shared memory)
__device__ __forceinline__ void fold_max(const float (&v)[QMAX], int* out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < QMAX; ++q) {
    const int k = __reduce_max_sync(0xffffffffu, fkey(v[q]));
    if (lane == 0) atomicMax(&out[q], k);
  }
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
  int n, banks, channels, exact, k;
  float l2_svc, l2_lat, occ_rowhit, occ_rowmiss;
};

struct Ptrs {
  const float* t_s;
  const int *bank, *ch, *row;
  const uint8_t *use_l2, *go_dram, *byp, *hp;
  // the carry in, one pointer per QueueCarry field
  const float *bank_free, *bank_ts, *hp_free, *hp_ts, *hp_sa, *lp_free, *lp_ts, *lp_sa;
  const int* cur_row;
  float *t_head, *t0;
  uint8_t* row_hit;
  // the carry out
  float *o_bank_free, *o_bank_ts, *o_hp_free, *o_hp_ts, *o_hp_sa, *o_lp_free, *o_lp_ts,
      *o_lp_sa;
  int* o_cur_row;
};

// the carry fields the passes fold by max, in this order in s_out
enum { BFREE, BTS, HFREE, HTS, HSA, LFREE, LTS, LSA, NFIELD };

__global__ void __launch_bounds__(kMaxThreads) wave_queue_kernel(Params p, Ptrs g) {
  // dynamic shared memory: four [K][T + 1] arrays of the pass's slots, slot
  // i of thread t at i * (T + 1) + t: D the packed word, TS t_s, ROW the row
  // (B, after the row chain), A
  extern __shared__ float smem[];
  __shared__ ScanMem sm;
  // carried-in queue state, for per-slot lookups
  __shared__ float s_bfree[QMAX], s_bts[QMAX], s_hfree[QMAX], s_hts[QMAX], s_hsa[QMAX],
      s_lfree[QMAX], s_lts[QMAX], s_lsa[QMAX];
  __shared__ int s_row[QMAX];
  // the scans' carries across passes
  __shared__ float c1[2 * QMAX], c2[3 * QMAX], c3[QMAX], c4[QMAX], c5[QMAX];
  __shared__ int s_out[NFIELD][QMAX];

  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank()), nb = static_cast<int>(cl.num_blocks());
  const int tid = threadIdx.x, nt = blockDim.x, K = p.k, pitch = nt + 1;
  int par = 0;  // the scans' parity
  int* D = reinterpret_cast<int*>(smem);
  float* TS = smem + K * pitch;
  int* ROW = reinterpret_cast<int*>(TS + K * pitch);
  float* B = TS + K * pitch;  // ROW's words once the row chain is done
  float* A = B + K * pitch;

  if (tid < QMAX) {
    const bool b = tid < p.banks, c = tid < p.channels;
    s_bfree[tid] = b ? g.bank_free[tid] : 0.f;
    s_bts[tid] = b ? g.bank_ts[tid] : 0.f;
    s_hfree[tid] = c ? g.hp_free[tid] : 0.f;
    s_hts[tid] = c ? g.hp_ts[tid] : 0.f;
    s_hsa[tid] = c ? g.hp_sa[tid] : 0.f;
    s_lfree[tid] = c ? g.lp_free[tid] : 0.f;
    s_lts[tid] = c ? g.lp_ts[tid] : 0.f;
    s_lsa[tid] = c ? g.lp_sa[tid] : 0.f;
    s_row[tid] = c ? g.cur_row[tid] : -1;
    c1[tid] = 0.f;          // bank occupancy
    c1[QMAX + tid] = -1.f;  // last DRAM slot of the channel (none)
    c2[tid] = c2[QMAX + tid] = 0.f;  // HP, LP occupancy
    c2[2 * QMAX + tid] = -INFINITY;  // bank running max
    c3[tid] = c4[tid] = c5[tid] = -INFINITY;
#pragma unroll
    for (int f = 0; f < NFIELD; ++f) s_out[f][tid] = fkey(-INFINITY);
  }
  __syncthreads();

  const float svc = p.l2_svc, lat = p.l2_lat;
  for (int pass = 0; pass < p.n; pass += nb * K * nt) {
    const int base = pass + rank * K * nt;      // this block's first slot
    const int per = max(0, min(K * nt, p.n - base));  // its slots of this pass
    const int first = base + tid * K;           // this thread's first slot
    const int kn = max(0, min(K, p.n - first));

    // ---- P0: the pass's slots into shared memory, coalesced; then bank
    // occupancy and the row chain's partials -----------------------------
    __syncthreads();  // the previous pass is done with the arrays
    for (int l = tid; l < per; l += nt) {
      const int j = base + l, t = l / K, s = (l - t * K) * pitch + t;
      D[s] = g.bank[j] | (g.ch[j] << 4) | (g.use_l2[j] ? kUl2 : 0) |
             (g.go_dram[j] ? kGd : 0) | (g.hp[j] ? kHp : 0) | (g.byp[j] ? kByp : 0);
      TS[s] = g.t_s[j];
      ROW[s] = g.row[j];
    }
    __syncthreads();
    float x1[2 * QMAX];
#pragma unroll
    for (int q = 0; q < QMAX; ++q) x1[q] = 0.f, x1[QMAX + q] = -1.f;
    for (int i = 0; i < kn; ++i) {
      const int d = D[i * pitch + tid];
      const int qb = d & 15, qc = (d >> 4) & 15;
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        if ((d & kUl2) && q == qb) x1[q] = x1[q] + svc;
        if ((d & kGd) && q == qc) x1[QMAX + q] = (float)(first + i);
      }
    }
    block_scan<QMAX>(x1, c1, sm, par, cl);

    // ---- P1: bank occupancy prefix, row hits; bank v, HP / LP occupancy ---
    {
      float cbs[QMAX], last[QMAX], x2[3 * QMAX];
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        cbs[q] = x1[q];
        last[q] = x1[QMAX + q];
        x2[q] = x2[QMAX + q] = 0.f;
        x2[2 * QMAX + q] = -INFINITY;
      }
      for (int i = 0; i < kn; ++i) {
        const int j = first + i, s = i * pitch + tid;
        int d = D[s];
        const int qb = d & 15, qc = (d >> 4) & 15;
        const bool ul2 = d & kUl2, gd = d & kGd, hpj = d & kHp;
        const float ts = TS[s];
        const float c_b = pick(cbs, qb);
        if (ul2) add_at(cbs, qb, svc);
        const int prev = (int)pick(last, qc);
        if (gd) put(last, qc, (float)j);
        // the previous DRAM slot of the channel: in this pass (shared
        // memory), in an earlier one (global), or none (the carried row)
        int prev_row = s_row[qc];
        if (prev >= base) {
          const int l = prev - base, t = l / K;
          prev_row = ROW[(l - t * K) * pitch + t];
        } else if (prev >= 0) {
          prev_row = __ldg(g.row + prev);
        }
        const bool rh = gd && prev_row == ROW[s];
        g.row_hit[j] = rh ? 1 : 0;
        if (rh) D[s] = d | kRh;
        const float occ = rh ? p.occ_rowhit : p.occ_rowmiss;
        const float f_b = carry_floor(p.exact, s_bfree[qb], s_bts[qb], s_bts[qb], ts, ts);
        const float v_b = ul2 ? fmaxf(ts, f_b) - c_b : -INFINITY;
        A[s] = c_b;
#pragma unroll
        for (int q = 0; q < QMAX; ++q) {
          if (gd && hpj && q == qc) x2[q] = x2[q] + occ;
          if (gd && !hpj && q == qc) x2[QMAX + q] = x2[QMAX + q] + occ;
          if (q == qb) x2[2 * QMAX + q] = fmaxf(x2[2 * QMAX + q], v_b);
        }
      }
      block_scan<2 * QMAX>(x2, c2, sm, par, cl);

      // ---- P2: bank starts, t_head, t_da; HP / LP prefixes; HP v --------
      float hs[QMAX], ls[QMAX], bm[QMAX], x3[QMAX], bfree[QMAX], bts[QMAX];
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        hs[q] = x2[q];
        ls[q] = x2[QMAX + q];
        bm[q] = x2[2 * QMAX + q];
      }
      fill(x3, -INFINITY);
      fill(bfree, -INFINITY);
      fill(bts, -INFINITY);
      for (int i = 0; i < kn; ++i) {
        const int j = first + i, s = i * pitch + tid;
        const int d = D[s];
        const int qb = d & 15, qc = (d >> 4) & 15;
        const bool ul2 = d & kUl2, gd = d & kGd, hpj = d & kHp;
        const float ts = TS[s];
        const float c_b = A[s];
        const float f_b = carry_floor(p.exact, s_bfree[qb], s_bts[qb], s_bts[qb], ts, ts);
        const float v_b = ul2 ? fmaxf(ts, f_b) - c_b : -INFINITY;
        const float mb = fmaxf(pick(bm, qb), v_b);
        put(bm, qb, mb);
        const float t_head = ul2 ? 0.f + (c_b + mb) : 0.f;
        g.t_head[j] = t_head;
        const float t_da = (d & kByp) ? ts : t_head + lat;
        A[s] = t_da;
        const float occ = (d & kRh) ? p.occ_rowhit : p.occ_rowmiss;
        const float c_h = pick(hs, qc), c_l = pick(ls, qc);
        if (gd && hpj) add_at(hs, qc, occ);
        if (gd && !hpj) add_at(ls, qc, occ);
        B[s] = hpj ? c_h : c_l;
        const float f_hp = carry_floor(p.exact, s_hfree[qc], s_hts[qc], s_hsa[qc], ts, t_da);
        const float v_h = (gd && hpj) ? fmaxf(t_da, f_hp) - c_h : -INFINITY;
        max_at(x3, qc, v_h);
        if (ul2) {
          max_at(bfree, qb, t_head + svc);
          max_at(bts, qb, ts);
        }
      }
      fold_max(bfree, s_out[BFREE]);
      fold_max(bts, s_out[BTS]);
      block_scan<0>(x3, c3, sm, par, cl);

      // ---- P3: HP starts and ends ----------------------------------------
      float x4[QMAX], hfree[QMAX], hts[QMAX], hsa[QMAX];
      fill(x4, -INFINITY);
      fill(hfree, -INFINITY);
      fill(hts, -INFINITY);
      fill(hsa, -INFINITY);
      for (int i = 0; i < kn; ++i) {
        const int j = first + i, s = i * pitch + tid;
        const int d = D[s];
        if (!(d & kHp)) continue;
        const int qc = (d >> 4) & 15;
        const bool mhp = d & kGd;
        const float ts = TS[s], t_da = A[s], c_h = B[s];
        const float f_hp = carry_floor(p.exact, s_hfree[qc], s_hts[qc], s_hsa[qc], ts, t_da);
        const float v_h = mhp ? fmaxf(t_da, f_hp) - c_h : -INFINITY;
        const float mh = fmaxf(pick(x3, qc), v_h);
        put(x3, qc, mh);
        const float hp_start = c_h + mh;
        g.t0[j] = hp_start;
        const float occ = (d & kRh) ? p.occ_rowhit : p.occ_rowmiss;
        const float hp_end = mhp ? hp_start + occ : -INFINITY;
        B[s] = hp_end;
        max_at(x4, qc, hp_end);
        if (mhp) {
          max_at(hfree, qc, hp_end);
          max_at(hts, qc, ts);
          max_at(hsa, qc, t_da);
        }
      }
      fold_max(hfree, s_out[HFREE]);
      fold_max(hts, s_out[HTS]);
      fold_max(hsa, s_out[HSA]);
      block_scan<0>(x4, c4, sm, par, cl);

      // ---- P4: strict priority: LP floors over the HP busy horizon; LP v --
      float x5[QMAX], lts[QMAX], lsa[QMAX];
      fill(x5, -INFINITY);
      fill(lts, -INFINITY);
      fill(lsa, -INFINITY);
      for (int i = 0; i < kn; ++i) {
        const int j = first + i, s = i * pitch + tid;
        const int d = D[s];
        const int qc = (d >> 4) & 15;
        if (d & kHp) {  // this slot's HP end joins the horizon of later slots
          max_at(x4, qc, B[s]);
          continue;
        }
        const bool mlp = d & kGd;
        const float hp_busy = pick(x4, qc);
        const float ts = TS[s], t_da = A[s], c_l = B[s];
        const float f_hp = carry_floor(p.exact, s_hfree[qc], s_hts[qc], s_hsa[qc], ts, t_da);
        const float f_lp = carry_floor(p.exact, s_lfree[qc], s_lts[qc], s_lsa[qc], ts, t_da);
        const float lp_floor = fmaxf(f_lp, fmaxf(f_hp, hp_busy));
        const float v_l = mlp ? fmaxf(t_da, lp_floor) - c_l : -INFINITY;
        A[s] = v_l;
        max_at(x5, qc, v_l);
        if (mlp) {
          max_at(lts, qc, ts);
          max_at(lsa, qc, t_da);
        }
      }
      fold_max(lts, s_out[LTS]);
      fold_max(lsa, s_out[LSA]);
      block_scan<0>(x5, c5, sm, par, cl);

      // ---- P5: LP starts and ends ----------------------------------------
      float lfree[QMAX];
      fill(lfree, -INFINITY);
      for (int i = 0; i < kn; ++i) {
        const int j = first + i, s = i * pitch + tid;
        const int d = D[s];
        if (d & kHp) continue;
        const int qc = (d >> 4) & 15;
        const float v_l = A[s], c_l = B[s];
        const float ml = fmaxf(pick(x5, qc), v_l);
        put(x5, qc, ml);
        const float lp_start = c_l + ml;
        g.t0[j] = lp_start;
        if (d & kGd) max_at(lfree, qc, lp_start + ((d & kRh) ? p.occ_rowhit : p.occ_rowmiss));
      }
      fold_max(lfree, s_out[LFREE]);
    }
  }

  // ---- the carry out: the blocks' folded maxima over the carried-in values,
  // by block 0 ---------------------------------------------------------------
  cl.sync();  // every block's maxima are in
  if (rank == 0 && tid < QMAX) {
    float r[NFIELD];
#pragma unroll
    for (int f = 0; f < NFIELD; ++f) {
      int k = fkey(-INFINITY);
#pragma unroll
      for (int b = 0; b < kMaxBlocks; ++b)
        if (b < nb) k = max(k, cl.map_shared_rank(&s_out[f][0], b)[tid]);
      r[f] = funkey(k);
    }
    if (tid < p.banks) {
      g.o_bank_free[tid] = fmaxf(s_bfree[tid], r[BFREE]);
      g.o_bank_ts[tid] = fmaxf(s_bts[tid], r[BTS]);
    }
    if (tid < p.channels) {
      g.o_hp_free[tid] = fmaxf(s_hfree[tid], r[HFREE]);
      g.o_hp_ts[tid] = fmaxf(s_hts[tid], r[HTS]);
      g.o_hp_sa[tid] = fmaxf(s_hsa[tid], r[HSA]);
      g.o_lp_free[tid] = fmaxf(s_lfree[tid], r[LFREE]);
      g.o_lp_ts[tid] = fmaxf(s_lts[tid], r[LTS]);
      g.o_lp_sa[tid] = fmaxf(s_lsa[tid], r[LSA]);
      const int last = (int)c1[QMAX + tid];
      g.o_cur_row[tid] = last >= 0 ? g.row[last] : s_row[tid];
    }
  }
  cl.sync();  // block 0 is done with the others' shared memory
}

}  // namespace

extern "C" {

const char* wave_queue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch one wave's timing pass. `args` (host) is one int64 array:
//   [0..7]   n, banks, channels, exact, blocks (of the cluster), threads, k
//            (slots a thread), smem_bytes — the host's plan
//            (plan_wave_queue in kernels/wavefront_scan/ops.py), launched
//            as it is;
//   [8..11]  the float32 bit patterns of l2_svc, l2_lat, occ_rowhit,
//            occ_rowmiss;
//   [12..40] device pointers, each a contiguous buffer (bool as one byte):
//            the slots [n] t_s, bank, ch, row, use_l2, go_dram, byp, hp; the
//            carry in bank_free, bank_ts [banks], hp_free, hp_ts, hp_sa,
//            lp_free, lp_ts, lp_sa, cur_row [channels]; the outputs t_head,
//            t0, row_hit [n]; the carry out, as the carry in;
//   [41]     the CUDA stream.
// Returns the cudaError_t of the launch; cudaErrorInvalidValue for a plan
// outside the kernel (1..8 banks and channels, a cluster of 1..8 blocks of
// 32..512 threads in whole warps, 1..16 slots a thread, shared memory for
// the plan's slots: 16 * k * (threads + 1) bytes).
int wave_queue_launch(const void* args) {
  const int64_t* a = static_cast<const int64_t*>(args);
  auto f32 = [](int64_t bits) {
    const int32_t b = static_cast<int32_t>(bits);
    float f;
    memcpy(&f, &b, sizeof f);
    return f;
  };
  const Params p{static_cast<int>(a[0]), static_cast<int>(a[1]), static_cast<int>(a[2]),
                 static_cast<int>(a[3]), static_cast<int>(a[6]), f32(a[8]),
                 f32(a[9]), f32(a[10]), f32(a[11])};
  const int blocks = static_cast<int>(a[4]), threads = static_cast<int>(a[5]);
  const int64_t smem = a[7];
  if (p.n < 0 || p.banks > QMAX || p.channels > QMAX || p.banks < 1 || p.channels < 1 ||
      blocks < 1 || blocks > kMaxBlocks || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || p.k < 1 || p.k > kMaxK || smem < 16LL * p.k * (threads + 1) ||
      smem > 232448 - 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const* q = reinterpret_cast<const void* const*>(a + 12);
  const Ptrs g{(const float*)q[0],   (const int*)q[1],      (const int*)q[2],
               (const int*)q[3],     (const uint8_t*)q[4],  (const uint8_t*)q[5],
               (const uint8_t*)q[6], (const uint8_t*)q[7],  (const float*)q[8],
               (const float*)q[9],   (const float*)q[10],   (const float*)q[11],
               (const float*)q[12],  (const float*)q[13],   (const float*)q[14],
               (const float*)q[15],  (const int*)q[16],     (float*)q[17],
               (float*)q[18],        (uint8_t*)q[19],       (float*)q[20],
               (float*)q[21],        (float*)q[22],         (float*)q[23],
               (float*)q[24],        (float*)q[25],         (float*)q[26],
               (float*)q[27],        (int*)q[28]};
  static int64_t allowed[kMaxDevices] = {};  // the opt-in set so far, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > 48 * 1024 && (dev >= kMaxDevices || smem > allowed[dev])) {
    e = cudaFuncSetAttribute(wave_queue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) allowed[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = reinterpret_cast<cudaStream_t>(a[41]);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = blocks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, wave_queue_kernel, p, g);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
