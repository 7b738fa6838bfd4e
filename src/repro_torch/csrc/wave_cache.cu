// wave_cache.cu — the wavefront engine's cache/classifier pass for one wave,
// on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/cache_pass/kernel.py: wave_cache_kernel (body
//   _cache_kernel); the per-lane math is src/repro/kernels/cache_pass/ref.py:
//   lane_cache_step.
// Plain version: src/repro_torch/kernels/cache_pass/ref.py
//   (wave_cache_pass_ref); the kernel is bitwise equal to it.
//
// What it computes. A wave of B warps issues L lanes of requests; lane k
// reads what lane k-1 wrote, so the lanes are sequential. Within a lane every
// decision is made from lane-start state: the bypass decision (classifier
// label, probe cadence, PC table, PCAL token, random draw), the set-indexed
// tag lookup, RRIP hit promotion / aging / victim choice, the evicted-address
// filter (EAF) bit, the insertion rank; then the writes: the victim's tag and
// inserting type, the set's RRIP row, EAF stamps with a generation reset, and
// the PC-table counters. Each slot's classifier rows observe the outcome.
// It emits 9 records [L, B] for the timing pass.
//
// What bounds it. A few hundred KB of state and records per wave at the
// paper's hierarchy (tags/rrip/meta 3 x 16 KB, EAF 16 KB, records 16 B per
// request): far from the card's bandwidth. It is latency-bound: L
// dependent lanes, each three block barriers long, with one block per wave.
//
// Design. One thread block runs the wave, one thread per slot (SPT slots
// per thread when B > 512: 2 or 4 on 512 threads, 8 or 16 on 1024; at 16,
// for waves above 8192 slots only, the per-slot registers spill to local
// memory). Each thread keeps its slots' six classifier
// rows in registers across all lanes, and fetches its next lane's address
// while the current lane runs. The cache state the lanes work on lives in
// one of two places, chosen by the host from the shapes alone
// (plan_wave_cache in kernels/cache_pass/ops.py):
//   * resident: the whole state (tags, rrip, meta, EAF, the three PC
//     tables) is copied from the input tensors into dynamic shared memory
//     with cp.async at the start (67 KB at the paper's hierarchy), every
//     lane reads and writes it there (way rows as int4 where ways % 4 == 0),
//     and at the end the whole state, touched sets or not, is written to
//     the output tensors;
//   * global: where the state does not fit, the kernel first copies the
//     inputs to the outputs and then updates the outputs in place.
// The inputs are never written. Each lane has two phases, each ended by
// __syncthreads():
//   1. read and claim: every decision from lane-start state; the victim is
//      the first maximal way (as jnp.argmax); the classifier observe; the
//      records. Same-set conflicts between slots of one lane resolve
//      last-write-wins in slot order, as the reference's scatters do: each
//      writing slot atomicMax-es its slot index into a per-set pointer table
//      in shared memory, one for the alloc chain (tags, meta) and one for
//      the RRIP chain (every cache-path request rewrites its set's row).
//      Same-lane allocators of one set share the lane-start row, hence the
//      victim, so a per-set winner is the per-element winner. Lanes claim
//      in two pairs of tables by turns, so a lane releases the claims of the
//      one before it without a barrier of its own;
//   2. write: the PC counters take the lane's adds (shared atomicAdd,
//      integer, exact in any order); the winners write
//      tags/meta and the RRIP row (recomputed from the lane-start row, which
//      only the winner touches); EAF stamps carry the lane-start generation;
//      thread 0 counts the evictions into the EAF reset.
//
// Arithmetic. All integer or select, except the classifier ratio
// hits / max(sampled, 1) (IEEE division: no fast math) and
// t0 + lane * lane_skew. Float constants come from the host as the float32
// rounding of the reference's Python doubles (e.g. 1.0 - 1e-6 rounded once).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
// waves of up to 2048 slots run on at most 512 threads (1, 2 or 4 slots a
// thread), which leaves a thread 128 registers; wider waves on 1024 (8 or
// 16 a thread, 64 registers)
constexpr int kMidThreads = 512;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned hash_bits(int x, unsigned salt) {
  unsigned h = static_cast<unsigned>(x) * 2654435761u + salt * 0x9E3779B9u;
  return h ^ (h >> 15);
}

__device__ __forceinline__ int hash_index(int x, unsigned salt, unsigned mod) {
  return static_cast<int>(hash_bits(x, salt) % mod);
}

// h % mod with the modulus fixed for the wave: a mask where it is a power
// of two (the paper's 512 sets and 4096 EAF bits), else the division
struct Mod {
  unsigned mod, mask;
  __device__ explicit Mod(int m)
      : mod(static_cast<unsigned>(m)), mask((m & (m - 1)) == 0 ? m - 1 : 0u) {}
  __device__ __forceinline__ int of(int x, unsigned salt) const {
    const unsigned h = hash_bits(x, salt);
    return static_cast<int>(mask ? h & mask : h % mod);
  }
};

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

// a select weight that contributes: +0 and -0 times {0, 1} add nothing
__device__ __forceinline__ bool bsel_nz(float w) { return w != 0.f; }

// ints rounded up to whole 16-byte words (shared-memory array starts)
__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

struct Params {
  int B, L, sets, ways, eaf_bits, pc_entries, rrip_max, eaf_capacity;
  float lane_skew, sampling_interval, probe_interval;
  float mostly_hit, mostly_miss, eps, one_minus_eps;
};

struct Inputs {
  const int *addr_lb, *pc_b, *owt_b;
  const uint8_t *slot_ok, *tokens_b;
  const float* t0;
  // PolicyArrays leaves
  const float *bypass_sel, *ins_sel, *sched_medic, *rand_p, *label_sel, *reclass_interval,
      *probe_interval;
};

struct Cache {  // the cache state and the classifier rows, in or out
  int *tags, *rrip, *meta, *eaf, *eaf_gen, *eaf_ctr, *pc_hits, *pc_acc, *pc_req;
  int *hits, *acc, *wtype;
  float* ratio;
  int *windows, *sampled;
};

struct Records {  // [L, B] each
  float* t;
  int* addr;
  uint8_t *valid, *byp, *use_l2, *hit, *hp;
  int* victim_type;
  uint8_t* ev_valid;
};

__device__ __forceinline__ void cp_async16(int* smem, const int* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(int* smem, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(src)
               : "memory");
}

// dst[0:n] = src[0:n] by the block, 16 bytes a thread where both are
// aligned; kToShared copies global -> shared with cp.async (the caller
// waits), else with loads and stores
template <bool kToShared>
__device__ void copy_ints(int* dst, const int* src, int n) {
  const bool v4 =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const int n4 = v4 ? n / 4 : 0;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    if (kToShared)
      cp_async16(dst + 4 * i, src + 4 * i);
    else
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
  }
  for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) {
    if (kToShared)
      cp_async4(dst + i, src + i);
    else
      dst[i] = src[i];
  }
}

template <int SPT, bool kResident, int kWays, int kThreads>
__global__ void __launch_bounds__(kThreads)
    wave_cache_kernel(Params p, Inputs in, Cache cin, Cache out, Records rec) {
  // dynamic shared memory: two pairs of per-set pointer tables [sets]
  // (alloc chain, RRIP chain; even lanes claim in the first pair, odd lanes
  // in the second), then, resident only, tags, rrip, meta [sets * ways], eaf
  // [eaf_bits], pc_hits, pc_acc, pc_req [pc_entries], each at a 16-byte start
  extern __shared__ __align__(16) int smem[];
  __shared__ int s_gen, s_ctr, s_nev;
  const int ways = kWays ? kWays : p.ways;  // kWays: the way count fixed at compile time
  const int sets4 = round4(p.sets), sw = p.sets * ways;
  int *tags, *rrip, *meta, *eaf, *pc_hits, *pc_acc, *pc_req;  // the working state
  if (kResident) {
    tags = smem + 4 * sets4;
    rrip = tags + round4(sw);
    meta = rrip + round4(sw);
    eaf = meta + round4(sw);
    pc_hits = eaf + round4(p.eaf_bits);
    pc_acc = pc_hits + round4(p.pc_entries);
    pc_req = pc_acc + round4(p.pc_entries);
  } else {
    tags = out.tags, rrip = out.rrip, meta = out.meta, eaf = out.eaf;
    pc_hits = out.pc_hits, pc_acc = out.pc_acc, pc_req = out.pc_req;
  }
  copy_ints<kResident>(tags, cin.tags, sw);
  copy_ints<kResident>(rrip, cin.rrip, sw);
  copy_ints<kResident>(meta, cin.meta, sw);
  copy_ints<kResident>(eaf, cin.eaf, p.eaf_bits);
  copy_ints<kResident>(pc_hits, cin.pc_hits, p.pc_entries);
  copy_ints<kResident>(pc_acc, cin.pc_acc, p.pc_entries);
  copy_ints<kResident>(pc_req, cin.pc_req, p.pc_entries);
  if (kResident) asm volatile("cp.async.commit_group;\n" ::: "memory");

  const int tid = threadIdx.x;
  for (int i = tid; i < 4 * sets4; i += blockDim.x) smem[i] = -1;
  if (tid == 0) {
    s_gen = *cin.eaf_gen;
    s_ctr = *cin.eaf_ctr;
    s_nev = 0;
  }

  // policy constants (observe_consts and the probe cadence)
  const float rc = *in.reclass_interval;
  const float interval = rc > 0.5f ? rc : p.sampling_interval;
  const int max_windows = in.label_sel[1] > 0.5f ? 1 : (1 << 30);
  const float pf = *in.probe_interval;
  const float probe_f = pf > 0.5f ? pf : p.probe_interval;
  const float min_samples = fminf(fmaxf(div_floor(interval, fmaxf(probe_f, 1.f)), 1.f), 8.f);
  const int pi = static_cast<int>(probe_f);
  const bool oracle = in.label_sel[2] > 0.5f;
  const bool sched_medic = *in.sched_medic > 0.5f;
  const float rand_p = *in.rand_p;
  const Mod set_mod(p.sets), eaf_mod(p.eaf_bits);
  // a bypass candidate or insertion rank whose select weight is 0 adds
  // exactly +0 to its sum: its inputs are not computed
  const bool use_probe = bsel_nz(in.bypass_sel[1]), use_pc = bsel_nz(in.bypass_sel[3]),
             use_rand = bsel_nz(in.bypass_sel[4]), use_eaf = bsel_nz(in.ins_sel[2]);
  // way rows as int4: shared-memory arrays start on 16 bytes by layout
  const bool v4 = (ways & 3) == 0 &&
                  (kResident || ((reinterpret_cast<uintptr_t>(tags) |
                                  reinterpret_cast<uintptr_t>(rrip)) & 15) == 0);
  float bsel[5], isel[3];
#pragma unroll
  for (int k = 0; k < 5; ++k) bsel[k] = in.bypass_sel[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) isel[k] = in.ins_sel[k];

  // per-slot registers: classifier rows and per-wave constants
  int c_hits[SPT], c_acc[SPT], c_wt[SPT], c_win[SPT], c_smp[SPT];
  int c_mod[SPT];  // c_acc % pi, kept as c_acc moves (pi > 0)
  float c_ratio[SPT];
  int pidx[SPT], owt[SPT];
  bool ok[SPT], tok[SPT];
  float t0[SPT];
  // per-slot decisions carried from the read phase to the writes
  int addr[SPT], sidx[SPT], victim[SPT], hit_way[SPT], rank[SPT], shift[SPT], wlab[SPT],
      eidx[SPT];
  bool use[SPT], hit[SPT], alloc[SPT], ev[SPT];
  int a_next[SPT];  // the next lane's addresses, in flight during this lane

#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int s = tid + k * blockDim.x;
    const bool in_b = s < p.B;
    c_hits[k] = in_b ? cin.hits[s] : 0;
    c_acc[k] = in_b ? cin.acc[s] : 0;
    c_mod[k] = pi > 0 ? c_acc[k] % pi : 0;
    c_wt[k] = in_b ? cin.wtype[s] : 0;
    c_win[k] = in_b ? cin.windows[s] : 0;
    c_smp[k] = in_b ? cin.sampled[s] : 0;
    c_ratio[k] = in_b ? cin.ratio[s] : 0.f;
    pidx[k] = in_b ? hash_index(in.pc_b[s], 3u, p.pc_entries) : 0;
    owt[k] = in_b ? in.owt_b[s] : 0;
    ok[k] = in_b && in.slot_ok[s];
    tok[k] = in_b && in.tokens_b[s];
    t0[k] = in_b ? in.t0[s] : 0.f;
    a_next[k] = in_b && p.L > 0 ? in.addr_lb[s] : -1;
    use[k] = hit[k] = alloc[k] = ev[k] = false;
  }
  if (kResident) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  for (int lane = 0; lane < p.L; ++lane) {
    int* p_alloc = smem + (lane & 1) * 2 * sets4;  // this lane's pointer tables
    int* p_rrip = p_alloc + sets4;
    int* q_alloc = smem + ((lane + 1) & 1) * 2 * sets4;  // the previous lane's
    const int gen0 = s_gen;  // lane-start generation
    int n_ev = 0;
    // ---- 1. read: decisions from lane-start state; claims -----------------
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int s = tid + k * blockDim.x;
      if (s >= p.B) continue;
      // release the previous lane's claims (its writes are done)
      if (alloc[k]) q_alloc[sidx[k]] = -1;
      if (use[k]) q_alloc[sets4 + sidx[k]] = -1;
      const int a = a_next[k];
      a_next[k] = lane + 1 < p.L ? in.addr_lb[(lane + 1) * p.B + s] : -1;
      const bool valid = a >= 0 && ok[k];
      addr[k] = a;
      // ①② label select + bypass decision
      const int wt = oracle ? owt[k] : c_wt[k];
      wlab[k] = wt;
      bool cand[5] = {false, false, !tok[k], false, false};
      if (use_probe) {
        const bool probe =
            pi != 0 && (pi > 0 ? c_mod[k] : c_acc[k] % pi) == pi - 1;
        cand[1] = wt <= 1 && !probe;
      }
      if (use_pc) {
        const int ph = pc_hits[pidx[k]], pa = pc_acc[pidx[k]], pr = pc_req[pidx[k]];
        const float pc_ratio = static_cast<float>(ph) / static_cast<float>(max(pa, 1));
        cand[3] = pa > 32 && pc_ratio < 0.25f && (pr % 16) != 15;
      }
      if (use_rand)
        cand[4] = static_cast<float>(hash_index(a, 7u, 65536u)) / 65536.0f < rand_p;
      float sel = 0.f;
#pragma unroll
      for (int m = 0; m < 5; ++m) sel = sel + bsel[m] * (cand[m] ? 1.f : 0.f);
      const bool byp = sel > 0.5f && valid;
      use[k] = valid && !byp;

      // L2 lookup: first matching way; RRIP hit promotion
      const int si = set_mod.of(a, 2u);
      sidx[k] = si;
      const int base = si * ways;
      int hw = -1, mx = -2147483647 - 1, vic = 0;
      bool h;
      if constexpr (kWays > 0) {
        // the row in registers, without branches: the first way holding a,
        // then the first maximal way of the promoted row
        int tg[kWays], rr[kWays];
#pragma unroll
        for (int w = 0; w < kWays; w += 4) {
          if (v4) {
            const int4 t = *reinterpret_cast<const int4*>(tags + base + w);
            const int4 r = *reinterpret_cast<const int4*>(rrip + base + w);
            tg[w] = t.x, tg[w + 1] = t.y, tg[w + 2] = t.z, tg[w + 3] = t.w;
            rr[w] = r.x, rr[w + 1] = r.y, rr[w + 2] = r.z, rr[w + 3] = r.w;
          } else {
#pragma unroll
            for (int u = w; u < w + 4 && u < kWays; ++u) {
              tg[u] = tags[base + u];
              rr[u] = rrip[base + u];
            }
          }
        }
        unsigned long long m = 0;
#pragma unroll
        for (int w = 0; w < kWays; ++w) m |= static_cast<unsigned long long>(tg[w] == a) << w;
        hw = m ? __ffsll(static_cast<long long>(m)) - 1 : -1;
        h = hw >= 0 && use[k];
#pragma unroll
        for (int w = 0; w < kWays; ++w) {
          rr[w] = (h && w == hw) ? 0 : rr[w];
          mx = max(mx, rr[w]);
        }
        unsigned long long e = 0;
#pragma unroll
        for (int w = 0; w < kWays; ++w) e |= static_cast<unsigned long long>(rr[w] == mx) << w;
        vic = __ffsll(static_cast<long long>(e)) - 1;
      } else {
        if (v4) {
          for (int w = 0; w < ways; w += 4) {
            const int4 t = *reinterpret_cast<const int4*>(tags + base + w);
            if (hw < 0)
              hw = t.x == a ? w : t.y == a ? w + 1 : t.z == a ? w + 2 : t.w == a ? w + 3 : -1;
          }
        } else {
          for (int w = 0; w < ways; ++w)
            if (hw < 0 && tags[base + w] == a) hw = w;
        }
        h = hw >= 0 && use[k];
        // ③ aging and victim: the first maximal way of the promoted row
        auto see = [&](int w, int r) {
          r = (h && w == hw) ? 0 : r;
          if (r > mx) mx = r, vic = w;
        };
        if (v4) {
          for (int w = 0; w < ways; w += 4) {
            const int4 r = *reinterpret_cast<const int4*>(rrip + base + w);
            see(w, r.x);
            see(w + 1, r.y);
            see(w + 2, r.z);
            see(w + 3, r.w);
          }
        } else {
          for (int w = 0; w < ways; ++w) see(w, rrip[base + w]);
        }
      }
      hit[k] = h;
      hit_way[k] = hw;
      alloc[k] = use[k] && !h;
      shift[k] = alloc[k] ? p.rrip_max - mx : 0;
      victim[k] = vic;
      const int evicted = tags[base + vic];
      const int vtype = meta[base + vic];
      // insertion rank: one-hot select over (lru, medic, eaf)
      const bool ebit = use_eaf && eaf[eaf_mod.of(a, 5u)] == gen0;
      const int r_medic = wt >= 3 ? 0 : (wt == 2 ? p.rrip_max - 2 : p.rrip_max - 1);
      const int r_eaf = ebit ? 0 : p.rrip_max - 1;
      const float rsel = isel[0] * 0.f + isel[1] * static_cast<float>(r_medic) +
                         isel[2] * static_cast<float>(r_eaf);
      rank[k] = static_cast<int>(rintf(rsel));
      ev[k] = alloc[k] && evicted >= 0;
      eidx[k] = ev[k] ? eaf_mod.of(evicted, 5u) : 0;
      n_ev += ev[k];
      // claim the set: last write wins in slot order
      if (alloc[k]) atomicMax(&p_alloc[si], s);
      if (use[k]) atomicMax(&p_rrip[si], s);

      // ① classifier observe on this slot's rows
      c_hits[k] += h ? 1 : 0;
      c_smp[k] += use[k] ? 1 : 0;
      if (valid) {
        c_acc[k] += 1;
        if (pi > 0) c_mod[k] = c_mod[k] + 1 == pi ? 0 : c_mod[k] + 1;
      }
      // the window's ratio and label only where the window ends
      if (static_cast<float>(c_acc[k]) >= interval) {
        const float ratio_now =
            static_cast<float>(c_hits[k]) / static_cast<float>(max(c_smp[k], 1));
        int t = 2;
        if (ratio_now <= p.mostly_miss) t = 1;
        if (ratio_now <= p.eps) t = 0;
        if (ratio_now >= p.mostly_hit) t = 3;
        if (ratio_now >= p.one_minus_eps) t = 4;
        if (!(static_cast<float>(c_smp[k]) >= min_samples)) t = 2;
        if (c_win[k] < max_windows) c_wt[k] = t;
        c_ratio[k] = ratio_now;
        c_win[k] += 1;
        c_hits[k] = c_acc[k] = c_smp[k] = c_mod[k] = 0;
      }

      const int o = lane * p.B + s;
      rec.t[o] = t0[k] + static_cast<float>(lane) * p.lane_skew;
      rec.addr[o] = a;
      rec.valid[o] = valid;
      rec.byp[o] = byp;
      rec.use_l2[o] = use[k];
      rec.hit[o] = h;
      rec.hp[o] = sched_medic && wt >= 3;
      rec.victim_type[o] = vtype;
      rec.ev_valid[o] = ev[k];
    }
    if (n_ev) atomicAdd(&s_nev, n_ev);
    __syncthreads();

    // ---- 2. write: PC counters, winners only, EAF stamps, generation -------
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int s = tid + k * blockDim.x;
      if (s >= p.B) continue;
      if (hit[k]) atomicAdd(&pc_hits[pidx[k]], 1);
      if (use[k]) atomicAdd(&pc_acc[pidx[k]], 1);
      if (addr[k] >= 0 && ok[k]) atomicAdd(&pc_req[pidx[k]], 1);
      const int base = sidx[k] * ways;
      if (alloc[k] && p_alloc[sidx[k]] == s) {
        tags[base + victim[k]] = addr[k];
        meta[base + victim[k]] = wlab[k];
      }
      if (use[k] && p_rrip[sidx[k]] == s) {
        // the lane-start row, promoted and aged; the victim takes the rank
        const int hw = hit[k] ? hit_way[k] : -1, vic = alloc[k] ? victim[k] : -1;
        auto next = [&](int w, int r) { return w == vic ? rank[k] : (w == hw ? 0 : r) + shift[k]; };
        if (v4) {
  #pragma unroll
        for (int w = 0; w < ways; w += 4) {
            int4* row = reinterpret_cast<int4*>(rrip + base + w);
            int4 r = *row;
            r.x = next(w, r.x);
            r.y = next(w + 1, r.y);
            r.z = next(w + 2, r.z);
            r.w = next(w + 3, r.w);
            *row = r;
          }
        } else {
          for (int w = 0; w < ways; ++w) rrip[base + w] = next(w, rrip[base + w]);
        }
      }
      if (ev[k]) eaf[eidx[k]] = gen0;
    }
    if (tid == 0) {
      const int ctr = s_ctr + s_nev;
      const bool reset = ctr >= p.eaf_capacity;
      s_gen = reset ? gen0 + 1 : gen0;
      s_ctr = reset ? 0 : ctr;
      s_nev = 0;
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int s = tid + k * blockDim.x;
    if (s >= p.B) continue;
    out.hits[s] = c_hits[k];
    out.acc[s] = c_acc[k];
    out.wtype[s] = c_wt[k];
    out.windows[s] = c_win[k];
    out.sampled[s] = c_smp[k];
    out.ratio[s] = c_ratio[k];
  }
  // every state write happened before the last lane's (or the copy-in's)
  // barrier: write the whole resident state out, touched sets or not
  if (kResident) {
    copy_ints<false>(out.tags, tags, sw);
    copy_ints<false>(out.rrip, rrip, sw);
    copy_ints<false>(out.meta, meta, sw);
    copy_ints<false>(out.eaf, eaf, p.eaf_bits);
    copy_ints<false>(out.pc_hits, pc_hits, p.pc_entries);
    copy_ints<false>(out.pc_acc, pc_acc, p.pc_entries);
    copy_ints<false>(out.pc_req, pc_req, p.pc_entries);
  }
  if (tid == 0) {
    *out.eaf_gen = s_gen;
    *out.eaf_ctr = s_ctr;
  }
}

// the least dynamic shared memory an instance's layout takes, in bytes
size_t smem_needed(const Params& p, bool resident) {
  size_t ints = 4 * static_cast<size_t>(round4(p.sets));
  if (resident)
    ints += 3 * static_cast<size_t>(round4(p.sets * p.ways)) + round4(p.eaf_bits) +
            3 * static_cast<size_t>(round4(p.pc_entries));
  return ints * sizeof(int);
}

template <int SPT, bool kResident, int kWays, int kThreads>
cudaError_t launch(int threads, size_t smem, cudaStream_t stream, const Params& p,
                   const Inputs& in, const Cache& cin, const Cache& out, const Records& rec) {
  static size_t allowed[kMaxDevices] = {};  // this instance's opt-in, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= kMaxDevices || smem > allowed[dev])) {
    e = cudaFuncSetAttribute(wave_cache_kernel<SPT, kResident, kWays, kThreads>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) allowed[dev] = smem;
  }
  wave_cache_kernel<SPT, kResident, kWays, kThreads><<<1, threads, smem, stream>>>(p, in, cin,
                                                                                  out, rec);
  return cudaGetLastError();
}

// the paper's 8 ways get their own instances (rows fully unrolled)
template <int SPT, bool kResident, int kThreads>
cudaError_t launch_ways(int threads, size_t smem, cudaStream_t s, const Params& p,
                        const Inputs& in, const Cache& cin, const Cache& out,
                        const Records& rec) {
  if (p.ways == 8)
    return launch<SPT, kResident, 8, kThreads>(threads, smem, s, p, in, cin, out, rec);
  return launch<SPT, kResident, 0, kThreads>(threads, smem, s, p, in, cin, out, rec);
}

template <bool kResident>
cudaError_t launch_spt(int spt, int threads, size_t smem, cudaStream_t s, const Params& p,
                       const Inputs& in, const Cache& cin, const Cache& out,
                       const Records& rec) {
  constexpr int M = kMidThreads, X = kMaxThreads;
  if (spt == 1) return launch_ways<1, kResident, M>(threads, smem, s, p, in, cin, out, rec);
  if (spt == 2) return launch_ways<2, kResident, M>(threads, smem, s, p, in, cin, out, rec);
  if (spt == 4) return launch_ways<4, kResident, M>(threads, smem, s, p, in, cin, out, rec);
  if (spt == 8) return launch_ways<8, kResident, X>(threads, smem, s, p, in, cin, out, rec);
  if (spt == 16) return launch_ways<16, kResident, X>(threads, smem, s, p, in, cin, out, rec);
  return cudaErrorInvalidValue;
}

Cache cache_at(const void* const* q) {
  Cache c;
  int** ints[] = {&c.tags,    &c.rrip,   &c.meta,   &c.eaf,  &c.eaf_gen, &c.eaf_ctr,
                  &c.pc_hits, &c.pc_acc, &c.pc_req, &c.hits, &c.acc,     &c.wtype};
  for (int i = 0; i < 12; ++i) *ints[i] = (int*)q[i];
  c.ratio = (float*)q[12];
  c.windows = (int*)q[13];
  c.sampled = (int*)q[14];
  return c;
}

}  // namespace

extern "C" {

const char* wave_cache_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch one wave's cache pass on `stream`.
//   dims   (host) int[8]: B, L, sets, ways, eaf_bits, pc_entries, rrip_max,
//          eaf_capacity;
//   consts (host) float[7]: lane_skew, sampling_interval, probe_interval,
//          mostly_hit, mostly_miss, eps, one_minus_eps;
//   ptrs   (host) 52 device pointers, each a contiguous buffer (bool as
//          one byte): the wave's inputs addr_lb, pc_b, owt_b, slot_ok,
//          tokens_b, t0; the policy's bypass_sel, ins_sel, sched_medic,
//          rand_p, label_sel, reclass_interval, probe_interval; the input
//          state tags, rrip, meta, eaf, eaf_gen, eaf_ctr, pc_hits, pc_acc,
//          pc_req and classifier rows hits, acc, wtype, ratio, windows,
//          sampled; the same 15 for the outputs; the 9 records [L, B] t,
//          addr, valid, byp, use_l2, hit, hp, victim_type, ev_valid;
//   resident != 0 keeps the state in shared memory (else in the outputs);
//   threads, spt (slots a thread: 1, 2, 4, 8 or 16) and smem_bytes (dynamic
//          shared memory) are the host's plan (plan_wave_cache in
//          kernels/cache_pass/ops.py), launched as they are.
// The inputs are read only. Returns the cudaError_t of the launch;
// cudaErrorInvalidValue for a plan that does not cover the wave or the
// instance's layout.
int wave_cache_launch(const void* dims, const void* consts, const void* ptrs, int resident,
                      int threads, int spt, int smem_bytes, void* stream) {
  const int* d = static_cast<const int*>(dims);
  const float* c = static_cast<const float*>(consts);
  const void* const* q = static_cast<const void* const*>(ptrs);
  Params p{d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7],
           c[0], c[1], c[2], c[3], c[4], c[5], c[6]};
  if (p.B < 1 || p.L < 0 || p.sets < 1 || p.ways < 1 || p.eaf_bits < 1 || p.pc_entries < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Inputs in{(const int*)q[0],     (const int*)q[1],     (const int*)q[2],
            (const uint8_t*)q[3], (const uint8_t*)q[4], (const float*)q[5],
            (const float*)q[6],   (const float*)q[7],   (const float*)q[8],
            (const float*)q[9],   (const float*)q[10],  (const float*)q[11],
            (const float*)q[12]};
  const Cache cin = cache_at(q + 13), out = cache_at(q + 28);
  Records rec{(float*)q[43],   (int*)q[44],     (uint8_t*)q[45],
              (uint8_t*)q[46], (uint8_t*)q[47], (uint8_t*)q[48],
              (uint8_t*)q[49], (int*)q[50],     (uint8_t*)q[51]};
  // the instances of 1, 2 and 4 slots a thread take up to 512 threads, of 8
  // and 16 up to 1024
  if (threads < 32 || threads % 32 != 0 || threads > (spt >= 8 ? kMaxThreads : kMidThreads) ||
      static_cast<long long>(spt) * threads < p.B || smem_bytes < 0 ||
      static_cast<size_t>(smem_bytes) < smem_needed(p, resident != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = resident ? launch_spt<true>(spt, threads, smem, s, p, in, cin, out, rec)
                                 : launch_spt<false>(spt, threads, smem, s, p, in, cin, out, rec);
  return static_cast<int>(e);
}

}  // extern "C"
