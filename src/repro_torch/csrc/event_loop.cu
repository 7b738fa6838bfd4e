// event_loop.cu — the exact discrete-event engine's loop, on Hopper: one
// thread block runs one whole simulation.
//
// Replaces no Pallas kernel: the reference runs this loop as a lax.scan,
//   src/repro/core/engine/event.py: simulate_core (with _request_step),
// vmapped over policies and seeds (src/repro/core/engine/__init__.py).
// Plain version: src/repro_torch/core/engine/event.py (event_loop, one
//   batched eager op per step of the reference's scalar loop); the kernel is
//   bitwise equal to it on every output.
//
// What it computes. N = P·S simulations, simulation n running policy
// p = n / S on trace seed s = n % S. Each runs I·W event steps: pop the
// active warp with the earliest ready time (ties to the lowest warp), then
// service the L requests of its next instruction one at a time: bypass
// decision (label, probe cadence, PCAL token, PC table, random draw), L2
// bank queue, set lookup (first matching way), RRIP promotion / aging /
// victim (first maximal way) and insertion rank, evicted-address filter
// (EAF) with its generation reset, two-queue FR-FCFS DRAM timing with the
// open row, the classifier observe, the PC-table and lifetime counters, and
// the metrics. The warp is ready again at its slowest request plus the
// compute gap; the sampled ratio is snapshot per (instruction, warp).
//
// What bounds it. Nothing the card is rated for: a simulation moves a few
// MB and does a few hundred integer and float operations a request. It is
// latency-bound: I·W·L dependent request steps (49,152 at the paper's
// scale), each reading its cache set's row and writing it back before the
// next request may read it.
//
// Design. One warp per block, one block per simulation, all N blocks in one
// launch. The whole cache state (tags, RRIP, inserting type, EAF, the three
// PC tables, the L2 bank and DRAM channel queues) lives in dynamic shared
// memory where it fits (67 KB at the paper's hierarchy); the per-warp rows
// (ready time, pointer, six classifier counters, two lifetime counters) too
// where they fit beside it; else either lives in the output tensors in
// global memory. The host picks the instance from the shapes alone
// (plan_event_loop in kernels/event_loop/ops.py), so every shape the
// reference runs has one. The 32 lanes compute every scalar of a request
// redundantly (uniform values, broadcast reads); the warp splits only the
// earliest-ready pop (a warp-wide argmin over W) and the set's ways (lane j
// reads way j; ballots give the first matching and the first maximal way;
// __reduce_max_sync the row's maximum). The current warp's classifier and
// lifetime counters and its instruction's PC-table entry stay in registers
// for the L requests. A request step reads everything it needs, then
// (after a __syncwarp()) writes: lane 0 the scalars, each lane its own ways,
// and ends with a __syncwarp(). The metrics' histograms are spread one bin a
// lane.
//
// Arithmetic. The same float32 operations in the same order as the plain
// version: t0 + k·lane_skew, the bank and DRAM max / add chains, qdelay_sum
// and stall_cycles in request order, the IEEE ratio divisions. Built with
// --fmad=false and no fast math; float constants come from the host as the
// float32 rounding of the reference's Python doubles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr int kQBins = 12;  // state.N_QBINS
constexpr int kTypes = 5;   // warp_types.NUM_TYPES

__device__ __forceinline__ unsigned hash_bits(int x, unsigned salt) {
  unsigned h = static_cast<unsigned>(x) * 2654435761u + salt * 0x9E3779B9u;
  return h ^ (h >> 15);
}

__device__ __forceinline__ int hash_index(int x, unsigned salt, unsigned mod) {
  return static_cast<int>(hash_bits(x, salt) % mod);
}

// h % mod with the modulus fixed for the run: a mask where it is a power of
// two (the paper's 512 sets, 8 channels, 4096 EAF bits, 256 PC entries),
// else the division
struct Mod {
  unsigned mod, mask;
  __device__ explicit Mod(int m)
      : mod(static_cast<unsigned>(m)), mask((m & (m - 1)) == 0 ? m - 1 : 0u) {}
  __device__ __forceinline__ int of(int x, unsigned salt) const {
    const unsigned h = hash_bits(x, salt);
    return static_cast<int>(mask ? h & mask : h % mod);
  }
};

// Python's (torch's, jnp's) integer floor division and modulo
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}
__device__ __forceinline__ int py_mod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// torch's (and CPython's) float floor division
__device__ __forceinline__ float div_floor(float a, float b) {
  if (b == 0.f) return a / b;
  const float mod = fmodf(a, b);
  float div = (a - mod) / b;
  if ((mod != 0.f) && ((b < 0.f) != (mod < 0.f))) div -= 1.f;
  if (div == 0.f) return copysignf(0.f, a / b);
  float fl = floorf(div);
  if (div - fl > 0.5f) fl += 1.f;
  return fl;
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

struct Params {
  int N, S, I, W, L, sets, ways, banks, channels, eaf_bits, pc_entries, rrip_max, eaf_capacity,
      row_lines;
  float lane_skew, l2_svc, l2_lat, occ_rowhit, occ_rowmiss, t_rowhit, t_rowmiss,
      sampling_interval, probe_interval, mostly_hit, mostly_miss, eps, one_minus_eps;
};

struct Inputs {
  const int *lines, *pcs, *oracle;  // [S, I, W, L], [S, I, W], [S, I, W]
  const float* gap;                 // [S, I]
  const uint8_t* tokens;            // [N, W]
  // PolicyArrays rows, [N, ...]
  const float *bypass_sel, *ins_sel, *sched_medic, *rand_p, *label_sel, *reclass_interval,
      *probe_interval;
};

struct Outputs {  // [N, ...] each
  int *tags, *rrip, *meta, *eaf, *eaf_gen, *eaf_ctr, *pc_hits, *pc_acc, *pc_req;
  float* bank_free;
  int* cur_row;
  float *hp_free, *lp_free;
  int *hits, *acc, *wtype;
  float* ratio;
  int *windows, *sampled, *tot_hits, *tot_acc;
  float* ready;
  int* ptr;
  float* ratio_t;  // [N, I, W]
  int* qdelay_hist;
  float* qdelay_sum;
  int *l2_accesses, *l2_hits, *dram_accesses, *row_hits, *bypasses;
  float* stall_cycles;
  int* evictions;
};

// the ratio -> warp-type ladder of warp_types.classify
__device__ __forceinline__ int classify(float r, int sampled, float min_samples, const Params& p) {
  int t = 2;
  if (r <= p.mostly_miss) t = 1;
  if (r <= p.eps) t = 0;
  if (r >= p.mostly_hit) t = 3;
  if (r >= p.one_minus_eps) t = 4;
  if (!(static_cast<float>(sampled) >= min_samples)) t = 2;
  return t;
}

template <typename T>
__device__ __forceinline__ void fill(T* dst, int n, T v) {
  for (int i = threadIdx.x; i < n; i += 32) dst[i] = v;
}

template <typename T>
__device__ __forceinline__ void copy_out(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += 32) dst[i] = src[i];
}

template <bool kStateSmem, bool kRowsSmem>
__global__ void __launch_bounds__(32) event_loop_kernel(Params p, Inputs in, Outputs out) {
  extern __shared__ __align__(16) int smem[];
  const int n = blockIdx.x, s = n % p.S, lane = threadIdx.x;
  const int sw = p.sets * p.ways, W = p.W;

  // ---- where the state and the rows live ---------------------------------
  int *tags, *rrip, *meta, *eaf, *pc_hits, *pc_acc, *pc_req, *cur_row;
  float *bank_free, *hp_free, *lp_free;
  int* cursor = smem;
  if (kStateSmem) {
    tags = cursor, cursor += round4(sw);
    rrip = cursor, cursor += round4(sw);
    meta = cursor, cursor += round4(sw);
    eaf = cursor, cursor += round4(p.eaf_bits);
    pc_hits = cursor, cursor += round4(p.pc_entries);
    pc_acc = cursor, cursor += round4(p.pc_entries);
    pc_req = cursor, cursor += round4(p.pc_entries);
    bank_free = reinterpret_cast<float*>(cursor), cursor += round4(p.banks);
    cur_row = cursor, cursor += round4(p.channels);
    hp_free = reinterpret_cast<float*>(cursor), cursor += round4(p.channels);
    lp_free = reinterpret_cast<float*>(cursor), cursor += round4(p.channels);
  } else {
    tags = out.tags + static_cast<size_t>(n) * sw;
    rrip = out.rrip + static_cast<size_t>(n) * sw;
    meta = out.meta + static_cast<size_t>(n) * sw;
    eaf = out.eaf + static_cast<size_t>(n) * p.eaf_bits;
    pc_hits = out.pc_hits + static_cast<size_t>(n) * p.pc_entries;
    pc_acc = out.pc_acc + static_cast<size_t>(n) * p.pc_entries;
    pc_req = out.pc_req + static_cast<size_t>(n) * p.pc_entries;
    bank_free = out.bank_free + static_cast<size_t>(n) * p.banks;
    cur_row = out.cur_row + static_cast<size_t>(n) * p.channels;
    hp_free = out.hp_free + static_cast<size_t>(n) * p.channels;
    lp_free = out.lp_free + static_cast<size_t>(n) * p.channels;
  }
  float *ready, *ratio;
  int *ptr, *hits, *acc, *wtype, *windows, *sampled, *tot_hits, *tot_acc;
  const size_t nw = static_cast<size_t>(n) * W;
  if (kRowsSmem) {
    const int rw = round4(W);
    ready = reinterpret_cast<float*>(cursor), cursor += rw;
    ratio = reinterpret_cast<float*>(cursor), cursor += rw;
    ptr = cursor, cursor += rw;
    hits = cursor, cursor += rw;
    acc = cursor, cursor += rw;
    wtype = cursor, cursor += rw;
    windows = cursor, cursor += rw;
    sampled = cursor, cursor += rw;
    tot_hits = cursor, cursor += rw;
    tot_acc = cursor, cursor += rw;
  } else {
    ready = out.ready + nw, ratio = out.ratio + nw, ptr = out.ptr + nw;
    hits = out.hits + nw, acc = out.acc + nw, wtype = out.wtype + nw;
    windows = out.windows + nw, sampled = out.sampled + nw;
    tot_hits = out.tot_hits + nw, tot_acc = out.tot_acc + nw;
  }

  // ---- init_state ----------------------------------------------------------
  fill(tags, sw, -1);
  fill(rrip, sw, p.rrip_max);
  fill(meta, sw, 2);  // BALANCED
  fill(eaf, p.eaf_bits, 0);
  fill(pc_hits, p.pc_entries, 0);
  fill(pc_acc, p.pc_entries, 0);
  fill(pc_req, p.pc_entries, 0);
  fill(bank_free, p.banks, 0.f);
  fill(cur_row, p.channels, -1);
  fill(hp_free, p.channels, 0.f);
  fill(lp_free, p.channels, 0.f);
  fill(ready, W, 0.f);
  fill(ratio, W, 0.5f);
  fill(ptr, W, 0);
  fill(hits, W, 0);
  fill(acc, W, 0);
  fill(wtype, W, 2);
  fill(windows, W, 0);
  fill(sampled, W, 0);
  fill(tot_hits, W, 0);
  fill(tot_acc, W, 0);
  int gen = 1, ctr = 0;

  // ---- the policy's constants ----------------------------------------------
  const float rc = in.reclass_interval[n];
  const float interval = rc > 0.5f ? rc : p.sampling_interval;
  const int max_windows = in.label_sel[3 * n + 1] > 0.5f ? 1 : (1 << 30);
  const float pf = in.probe_interval[n];
  const float probe_f = pf > 0.5f ? pf : p.probe_interval;
  const float min_samples = fminf(fmaxf(div_floor(interval, fmaxf(probe_f, 1.f)), 1.f), 8.f);
  const int pi = static_cast<int>(probe_f);
  const bool oracle = in.label_sel[3 * n + 2] > 0.5f;
  const bool sched_medic = in.sched_medic[n] > 0.5f;
  const float rand_p = in.rand_p[n];
  float bsel[5], isel[3];
#pragma unroll
  for (int k = 0; k < 5; ++k) bsel[k] = in.bypass_sel[5 * n + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) isel[k] = in.ins_sel[3 * n + k];
  // with a window of at most 0 accesses every warp is due on every request
  const bool all_due = 0.f >= interval;
  // a bypass candidate or insertion rank whose select weight is 0 adds
  // exactly +0 to its sum: its inputs are not computed
  const bool use_probe = bsel[1] != 0.f, use_pc = bsel[3] != 0.f, use_rand = bsel[4] != 0.f,
             use_eaf = isel[2] != 0.f;
  const Mod bank_mod(p.banks), set_mod(p.sets), ch_mod(p.channels), eaf_mod(p.eaf_bits);
  // a power-of-two row is an arithmetic shift (floor division)
  const int row_shift = (p.row_lines > 0 && (p.row_lines & (p.row_lines - 1)) == 0)
                            ? __ffs(p.row_lines) - 1
                            : -1;

  // the metrics: scalars in registers, the histograms one bin a lane
  float qdelay_sum = 0.f, stall = 0.f;
  int l2_accesses = 0, l2_hits = 0, dram_accesses = 0, row_hits = 0, bypasses = 0;
  int hist = 0, evict = 0;
  __syncwarp();

  const float kInf = __int_as_float(0x7f800000);
  for (int step = 0; step < p.I * W; ++step) {
    // ---- the earliest-ready active warp, ties to the lowest index ----------
    float best = kInf;
    int w = 0x7fffffff;
    for (int v = lane; v < W; v += 32) {
      const float r = ptr[v] < p.I ? ready[v] : kInf;
      if (r < best) best = r, w = v;
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int ow = __shfl_xor_sync(kFull, w, off);
      if (ob < best || (ob == best && ow < w)) best = ob, w = ow;
    }
    const int i = ptr[w];
    const float t0 = ready[w];
    const size_t cell = (static_cast<size_t>(s) * p.I + i) * W + w;
    const int pc = in.pcs[cell], owt = in.oracle[cell];
    const float gap = in.gap[static_cast<size_t>(s) * p.I + i];
    const bool token = in.tokens[nw + w] != 0;
    const int* lrow = in.lines + cell * p.L;
    // the warp's rows and the instruction's PC-table entry, in registers
    int c_hits = hits[w], c_acc = acc[w], c_wt = wtype[w], c_win = windows[w],
        c_smp = sampled[w], c_th = tot_hits[w], c_ta = tot_acc[w];
    float c_ratio = ratio[w];
    int c_mod = pi > 0 ? c_acc % pi : 0;  // c_acc % pi, kept as c_acc moves
    const int pidx = hash_index(pc, 3u, p.pc_entries);
    int ph = pc_hits[pidx], pa = pc_acc[pidx], pr = pc_req[pidx];
    float dmax = -kInf, dmin = kInf;
    int a_lane = lane < p.L ? lrow[lane] : -1;

    for (int k = 0; k < p.L; ++k) {
      if (k && (k & 31) == 0) a_lane = k + lane < p.L ? lrow[k + lane] : -1;
      const int a = __shfl_sync(kFull, a_lane, k & 31);
      const float t_arr = t0 + static_cast<float>(k) * p.lane_skew;
      const bool valid = a >= 0;

      // ①② label select + bypass decision
      const int wt = oracle ? owt : c_wt;
      bool cand[5] = {false, false, !token, false, false};
      if (use_probe) {
        const bool probe = pi != 0 && (pi > 0 ? c_mod : py_mod(c_acc, pi)) == pi - 1;
        cand[1] = wt <= 1 && !probe;
      }
      if (use_pc) {
        const float pc_ratio = static_cast<float>(ph) / static_cast<float>(max(pa, 1));
        cand[3] = pa > 32 && pc_ratio < 0.25f && (pr & 15) != 15;
      }
      if (use_rand)
        cand[4] = static_cast<float>(hash_bits(a, 7u) & 65535u) / 65536.0f < rand_p;
      float sel = 0.f;
#pragma unroll
      for (int m = 0; m < 5; ++m) sel = sel + bsel[m] * (cand[m] ? 1.f : 0.f);
      const bool byp = sel > 0.5f && valid;
      const bool use = valid && !byp;

      // L2 bank queue
      const int bank = bank_mod.of(a, 1u);
      const float t_head = fmaxf(bank_free[bank], t_arr);
      const float qdelay = use ? t_head - t_arr : 0.f;

      // ③ insertion rank (lru, medic, eaf), one-hot select
      const bool ebit = use_eaf && eaf[eaf_mod.of(a, 5u)] == gen;
      const int r_medic = wt >= 3 ? 0 : (wt == 2 ? p.rrip_max - 2 : p.rrip_max - 1);
      const int r_eaf = ebit ? 0 : p.rrip_max - 1;
      const float rsel =
          isel[0] * 0.f + isel[1] * static_cast<float>(r_medic) + isel[2] * static_cast<float>(r_eaf);
      const int rank = static_cast<int>(rintf(rsel));

      // L2 lookup: the first matching way, then the first maximal way of the
      // promoted row (lane j holds way j of each 32-way chunk)
      const int sidx = set_mod.of(a, 2u), base = sidx * p.ways;
      const bool one_chunk = p.ways <= 32, in_row = lane < p.ways;
      int tg = 0, rr = 0, mt = 0;
      if (one_chunk && in_row) tg = tags[base + lane], rr = rrip[base + lane], mt = meta[base + lane];
      int hw = -1;
      for (int c = 0; c < p.ways; c += 32) {
        const int j = c + lane;
        const bool is_a = j < p.ways && (one_chunk ? tg : tags[base + j]) == a;
        const unsigned m = __ballot_sync(kFull, is_a);
        if (hw < 0 && m) hw = c + __ffs(m) - 1;
      }
      const bool h = hw >= 0 && use;
      int lmx = -2147483647 - 1;
      for (int j = lane; j < p.ways; j += 32)
        lmx = max(lmx, (h && j == hw) ? 0 : (one_chunk ? rr : rrip[base + j]));
      const int mx = __reduce_max_sync(kFull, lmx);
      int vic = -1;
      for (int c = 0; c < p.ways && vic < 0; c += 32) {
        const int j = c + lane;
        const bool is_mx =
            j < p.ways && ((h && j == hw) ? 0 : (one_chunk ? rr : rrip[base + j])) == mx;
        const unsigned m = __ballot_sync(kFull, is_mx);
        if (m) vic = c + __ffs(m) - 1;
      }
      // the victim's tag and type, read before they are overwritten
      const int evicted = one_chunk ? __shfl_sync(kFull, tg, vic) : tags[base + vic];
      const int vtype = one_chunk ? __shfl_sync(kFull, mt, vic) : meta[base + vic];
      const bool alloc = use && !h;
      const bool ev = alloc && evicted >= 0;
      const int shift = alloc ? p.rrip_max - mx : 0;

      // ④ DRAM two-queue FR-FCFS with the open row
      const bool go = valid && (byp || !h);
      const float t_dram_arr = byp ? t_arr : t_head + p.l2_lat;
      const int row = row_shift >= 0 ? a >> row_shift : floor_div(a, p.row_lines);
      const int ch = ch_mod.of(row, 4u);
      const bool row_hit = cur_row[ch] == row && go;
      const float occ = row_hit ? p.occ_rowhit : p.occ_rowmiss;
      const float lat = row_hit ? p.t_rowhit : p.t_rowmiss;
      const bool hp = sched_medic && wt >= 3;
      const float hpf = hp_free[ch], lpf = lp_free[ch];
      const float t0d = hp ? fmaxf(hpf, t_dram_arr) : fmaxf(fmaxf(lpf, hpf), t_dram_arr);
      float t_done = h ? t_head + p.l2_lat : t0d + lat;
      t_done = valid ? t_done : t_arr;
      __syncwarp();  // every read of the step before any of its writes

      // the writes: the set's RRIP row (each lane its ways), the victim way,
      // the EAF stamp (the step's starting generation), the queues
      if (use)
        for (int j = lane; j < p.ways; j += 32) {
          const int r = (h && j == hw) ? 0 : (one_chunk ? rr : rrip[base + j]);
          rrip[base + j] = alloc && j == vic ? rank : r + shift;
        }
      if (alloc && lane == (vic & 31)) {
        tags[base + vic] = a;
        meta[base + vic] = wt;
      }
      if (lane == 0) {
        if (ev) eaf[eaf_mod.of(evicted, 5u)] = gen;
        if (use) bank_free[bank] = t_head + p.l2_svc;
        if (go && hp) hp_free[ch] = t0d + occ;
        if (go && !hp) lp_free[ch] = t0d + occ;
        if (go) cur_row[ch] = row;
      }
      ctr += ev ? 1 : 0;
      if (ctr >= p.eaf_capacity) gen += 1, ctr = 0;

      // ① classifier observe (weight: valid; probed: the cache path)
      c_hits += h ? 1 : 0;
      c_smp += use ? 1 : 0;
      if (valid) {
        c_acc += 1;
        if (pi > 0) c_mod = c_mod + 1 == pi ? 0 : c_mod + 1;
      }
      if (static_cast<float>(c_acc) >= interval) {
        const float ratio_now = static_cast<float>(c_hits) / static_cast<float>(max(c_smp, 1));
        const int t = classify(ratio_now, c_smp, min_samples, p);
        if (c_win < max_windows) c_wt = t;
        c_ratio = ratio_now;
        c_win += 1;
        c_hits = c_acc = c_smp = c_mod = 0;
      }
      if (all_due) {  // every other warp's window closes too
        for (int v = lane; v < W; v += 32) {
          if (v == w || !(static_cast<float>(acc[v]) >= interval)) continue;
          const float ratio_now =
              static_cast<float>(hits[v]) / static_cast<float>(max(sampled[v], 1));
          const int t = classify(ratio_now, sampled[v], min_samples, p);
          if (windows[v] < max_windows) wtype[v] = t;
          ratio[v] = ratio_now;
          windows[v] += 1;
          hits[v] = acc[v] = sampled[v] = 0;
        }
      }
      ph += h ? 1 : 0;
      pa += use ? 1 : 0;
      pr += valid ? 1 : 0;
      c_th += h ? 1 : 0;
      c_ta += valid ? 1 : 0;

      // metrics
      int qb = 0;
#pragma unroll
      for (int e = 0; e < kQBins - 1; ++e) qb += qdelay >= static_cast<float>(1 << e) ? 1 : 0;
      hist += (lane == qb && use) ? 1 : 0;
      qdelay_sum = qdelay_sum + qdelay;
      l2_accesses += use ? 1 : 0;
      l2_hits += h ? 1 : 0;
      dram_accesses += go ? 1 : 0;
      row_hits += row_hit ? 1 : 0;
      bypasses += byp ? 1 : 0;
      evict += (lane == vtype && ev) ? 1 : 0;
      if (valid) dmax = fmaxf(dmax, t_done), dmin = fminf(dmin, t_done);
      __syncwarp();
    }

    // ---- the instruction retires ---------------------------------------------
    const bool has_req = dmax > -kInf;
    stall = stall + (has_req ? dmax - dmin : 0.f);
    if (lane == 0) {
      ready[w] = has_req ? dmax + gap : t0 + gap;
      ptr[w] = i + 1;
      hits[w] = c_hits, acc[w] = c_acc, wtype[w] = c_wt, windows[w] = c_win;
      sampled[w] = c_smp, ratio[w] = c_ratio, tot_hits[w] = c_th, tot_acc[w] = c_ta;
      pc_hits[pidx] = ph, pc_acc[pidx] = pa, pc_req[pidx] = pr;
      out.ratio_t[(static_cast<size_t>(n) * p.I + i) * W + w] = c_ratio;
    }
    __syncwarp();
  }

  // ---- write out -------------------------------------------------------------
  if (kStateSmem) {
    copy_out(out.tags + static_cast<size_t>(n) * sw, tags, sw);
    copy_out(out.rrip + static_cast<size_t>(n) * sw, rrip, sw);
    copy_out(out.meta + static_cast<size_t>(n) * sw, meta, sw);
    copy_out(out.eaf + static_cast<size_t>(n) * p.eaf_bits, eaf, p.eaf_bits);
    copy_out(out.pc_hits + static_cast<size_t>(n) * p.pc_entries, pc_hits, p.pc_entries);
    copy_out(out.pc_acc + static_cast<size_t>(n) * p.pc_entries, pc_acc, p.pc_entries);
    copy_out(out.pc_req + static_cast<size_t>(n) * p.pc_entries, pc_req, p.pc_entries);
    copy_out(out.bank_free + static_cast<size_t>(n) * p.banks, bank_free, p.banks);
    copy_out(out.cur_row + static_cast<size_t>(n) * p.channels, cur_row, p.channels);
    copy_out(out.hp_free + static_cast<size_t>(n) * p.channels, hp_free, p.channels);
    copy_out(out.lp_free + static_cast<size_t>(n) * p.channels, lp_free, p.channels);
  }
  if (kRowsSmem) {
    copy_out(out.ready + nw, ready, W);
    copy_out(out.ratio + nw, ratio, W);
    copy_out(out.ptr + nw, ptr, W);
    copy_out(out.hits + nw, hits, W);
    copy_out(out.acc + nw, acc, W);
    copy_out(out.wtype + nw, wtype, W);
    copy_out(out.windows + nw, windows, W);
    copy_out(out.sampled + nw, sampled, W);
    copy_out(out.tot_hits + nw, tot_hits, W);
    copy_out(out.tot_acc + nw, tot_acc, W);
  }
  if (lane < kQBins) out.qdelay_hist[n * kQBins + lane] = hist;
  if (lane < kTypes) out.evictions[n * kTypes + lane] = evict;
  if (lane == 0) {
    out.eaf_gen[n] = gen;
    out.eaf_ctr[n] = ctr;
    out.qdelay_sum[n] = qdelay_sum;
    out.stall_cycles[n] = stall;
    out.l2_accesses[n] = l2_accesses;
    out.l2_hits[n] = l2_hits;
    out.dram_accesses[n] = dram_accesses;
    out.row_hits[n] = row_hits;
    out.bypasses[n] = bypasses;
  }
}

// the least dynamic shared memory an instance's layout takes, in bytes
size_t smem_needed(const Params& p, bool state, bool rows) {
  size_t ints = 0;
  if (state)
    ints += 3 * static_cast<size_t>(round4(p.sets * p.ways)) + round4(p.eaf_bits) +
            3 * static_cast<size_t>(round4(p.pc_entries)) + round4(p.banks) +
            3 * static_cast<size_t>(round4(p.channels));
  if (rows) ints += 10 * static_cast<size_t>(round4(p.W));
  return ints * sizeof(int);
}

template <bool kState, bool kRows>
cudaError_t launch(size_t smem, cudaStream_t stream, const Params& p, const Inputs& in,
                   const Outputs& out) {
  static size_t allowed[kMaxDevices] = {};  // this instance's opt-in, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= kMaxDevices || smem > allowed[dev])) {
    e = cudaFuncSetAttribute(event_loop_kernel<kState, kRows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) allowed[dev] = smem;
  }
  event_loop_kernel<kState, kRows><<<p.N, 32, smem, stream>>>(p, in, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* event_loop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch the event loop of N simulations on `stream`, one block of 32
// threads each.
//   dims   (host) int[14]: N, S, I, W, L, sets, ways, banks, channels,
//          eaf_bits, pc_entries, rrip_max, eaf_capacity, row_lines;
//   consts (host) float[13]: lane_skew, l2_svc, l2_lat, occ_rowhit,
//          occ_rowmiss, t_rowhit, t_rowmiss, sampling_interval,
//          probe_interval, mostly_hit, mostly_miss, eps, one_minus_eps;
//   ptrs   (host) 45 device pointers, each a contiguous buffer (bool as one
//          byte): the inputs lines [S, I, W, L], pcs [S, I, W], oracle
//          [S, I, W], gap [S, I], tokens [N, W]; the policy rows [N, ...]
//          bypass_sel, ins_sel, sched_medic, rand_p, label_sel,
//          reclass_interval, probe_interval; the outputs [N, ...] tags, rrip,
//          meta, eaf, eaf_gen, eaf_ctr, pc_hits, pc_acc, pc_req, bank_free,
//          cur_row, hp_free, lp_free, hits, acc, wtype, ratio, windows,
//          sampled, tot_hits, tot_acc, ready, ptr, ratio_t [N, I, W],
//          qdelay_hist [N, 12], qdelay_sum, l2_accesses, l2_hits,
//          dram_accesses, row_hits, bypasses, stall_cycles,
//          evictions_by_type [N, 5];
//   state, rows != 0 keep the cache state / the per-warp rows in shared
//          memory (else in the outputs), smem_bytes of dynamic shared memory:
//          the host's plan (plan_event_loop in kernels/event_loop/ops.py),
//          launched as it is.
// Returns the cudaError_t of the launch; cudaErrorInvalidValue for shapes or
// a plan the kernel does not take.
int event_loop_launch(const void* dims, const void* consts, const void* ptrs, int state, int rows,
                      int smem_bytes, void* stream) {
  const int* d = static_cast<const int*>(dims);
  const float* c = static_cast<const float*>(consts);
  const void* const* q = static_cast<const void* const*>(ptrs);
  const Params p{d[0],  d[1],  d[2],  d[3],  d[4],  d[5],  d[6],  d[7],  d[8],  d[9],
                 d[10], d[11], d[12], d[13], c[0],  c[1],  c[2],  c[3],  c[4],  c[5],
                 c[6],  c[7],  c[8],  c[9],  c[10], c[11], c[12]};
  if (p.N < 1 || p.S < 1 || p.I < 0 || p.W < 1 || p.L < 0 || p.sets < 1 || p.ways < 1 ||
      p.banks < 1 || p.channels < 1 || p.eaf_bits < 1 || p.pc_entries < 1 || p.row_lines == 0 ||
      smem_bytes < 0 || static_cast<size_t>(smem_bytes) < smem_needed(p, state != 0, rows != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Inputs in{(const int*)q[0],    (const int*)q[1],    (const int*)q[2],
                  (const float*)q[3],  (const uint8_t*)q[4], (const float*)q[5],
                  (const float*)q[6],  (const float*)q[7],  (const float*)q[8],
                  (const float*)q[9],  (const float*)q[10], (const float*)q[11]};
  Outputs o;
  o.tags = (int*)q[12], o.rrip = (int*)q[13], o.meta = (int*)q[14], o.eaf = (int*)q[15];
  o.eaf_gen = (int*)q[16], o.eaf_ctr = (int*)q[17];
  o.pc_hits = (int*)q[18], o.pc_acc = (int*)q[19], o.pc_req = (int*)q[20];
  o.bank_free = (float*)q[21], o.cur_row = (int*)q[22];
  o.hp_free = (float*)q[23], o.lp_free = (float*)q[24];
  o.hits = (int*)q[25], o.acc = (int*)q[26], o.wtype = (int*)q[27], o.ratio = (float*)q[28];
  o.windows = (int*)q[29], o.sampled = (int*)q[30];
  o.tot_hits = (int*)q[31], o.tot_acc = (int*)q[32];
  o.ready = (float*)q[33], o.ptr = (int*)q[34], o.ratio_t = (float*)q[35];
  o.qdelay_hist = (int*)q[36], o.qdelay_sum = (float*)q[37];
  o.l2_accesses = (int*)q[38], o.l2_hits = (int*)q[39], o.dram_accesses = (int*)q[40];
  o.row_hits = (int*)q[41], o.bypasses = (int*)q[42], o.stall_cycles = (float*)q[43];
  o.evictions = (int*)q[44];
  const size_t smem = static_cast<size_t>(smem_bytes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (state)
    e = rows ? launch<true, true>(smem, st, p, in, o) : launch<true, false>(smem, st, p, in, o);
  else
    e = rows ? launch<false, true>(smem, st, p, in, o) : launch<false, false>(smem, st, p, in, o);
  return static_cast<int>(e);
}

}  // extern "C"
