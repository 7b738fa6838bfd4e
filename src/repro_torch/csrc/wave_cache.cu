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
// per thread when B > 1024). Each thread keeps its slots' six classifier
// rows in registers across all lanes. The cache state lives in the output
// buffers, which the wrapper clones from the inputs, and is updated in place.
// Each lane has three phases separated by __syncthreads():
//   1. read: every decision from lane-start state; the victim is the first
//      maximal way (as jnp.argmax); the classifier observe; the records;
//   2. resolve: same-set conflicts between slots of one lane resolve
//      last-write-wins in slot order, as the reference's scatters do. Each
//      writing slot atomicMax-es its slot index into a per-set pointer table
//      in shared memory: one for the alloc chain (tags, meta), one for the
//      RRIP chain (every cache-path request rewrites its set's row). Same-lane
//      allocators of one set share the lane-start row, hence the victim, so a
//      per-set winner is the per-element winner. PC counters take atomicAdd
//      (integer, exact in any order); the evictions are counted for the EAF
//      reset;
//   3. write: the winners write tags/meta and the RRIP row (recomputed from
//      the lane-start row, which only the winner touches); EAF stamps carry
//      the lane-start generation; thread 0 advances the generation.
// Then the touched pointer entries are cleared.
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

__device__ __forceinline__ int hash_index(int x, unsigned salt, unsigned mod) {
  unsigned h = static_cast<unsigned>(x) * 2654435761u + salt * 0x9E3779B9u;
  h ^= h >> 15;
  return static_cast<int>(h % mod);
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

struct State {  // updated in place
  int *tags, *rrip, *meta, *eaf, *eaf_gen, *eaf_ctr, *pc_hits, *pc_acc, *pc_req;
  int *hits, *acc, *wtype, *windows, *sampled;
  float* ratio;
};

struct Records {  // [L, B] each
  float* t;
  int* addr;
  uint8_t *valid, *byp, *use_l2, *hit, *hp;
  int* victim_type;
  uint8_t* ev_valid;
};

template <int SPT>
__global__ void __launch_bounds__(kMaxThreads)
    wave_cache_kernel(Params p, Inputs in, State st, Records rec) {
  extern __shared__ int s_ptr[];  // [2 * sets]: alloc chain, then RRIP chain
  int* p_alloc = s_ptr;
  int* p_rrip = s_ptr + p.sets;
  __shared__ int s_gen, s_ctr, s_nev;

  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * p.sets; i += blockDim.x) s_ptr[i] = -1;
  if (tid == 0) {
    s_gen = *st.eaf_gen;
    s_ctr = *st.eaf_ctr;
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
  float bsel[5], isel[3];
#pragma unroll
  for (int k = 0; k < 5; ++k) bsel[k] = in.bypass_sel[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) isel[k] = in.ins_sel[k];

  // per-slot registers: classifier rows and per-wave constants
  int c_hits[SPT], c_acc[SPT], c_wt[SPT], c_win[SPT], c_smp[SPT];
  float c_ratio[SPT];
  int pidx[SPT], owt[SPT];
  bool ok[SPT], tok[SPT];
  float t0[SPT];
  // per-slot decisions carried from the read phase to the writes
  int addr[SPT], sidx[SPT], victim[SPT], hit_way[SPT], rank[SPT], shift[SPT], wlab[SPT],
      eidx[SPT];
  bool use[SPT], hit[SPT], alloc[SPT], ev[SPT];

#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int s = tid + k * blockDim.x;
    const bool in_b = s < p.B;
    c_hits[k] = in_b ? st.hits[s] : 0;
    c_acc[k] = in_b ? st.acc[s] : 0;
    c_wt[k] = in_b ? st.wtype[s] : 0;
    c_win[k] = in_b ? st.windows[s] : 0;
    c_smp[k] = in_b ? st.sampled[s] : 0;
    c_ratio[k] = in_b ? st.ratio[s] : 0.f;
    pidx[k] = in_b ? hash_index(in.pc_b[s], 3u, p.pc_entries) : 0;
    owt[k] = in_b ? in.owt_b[s] : 0;
    ok[k] = in_b && in.slot_ok[s];
    tok[k] = in_b && in.tokens_b[s];
    t0[k] = in_b ? in.t0[s] : 0.f;
  }
  __syncthreads();

  for (int lane = 0; lane < p.L; ++lane) {
    const int gen0 = s_gen;  // lane-start generation
    int n_ev = 0;
    // ---- 1. read: decisions from lane-start state ------------------------
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int s = tid + k * blockDim.x;
      use[k] = hit[k] = alloc[k] = ev[k] = false;
      if (s >= p.B) continue;
      const int a = in.addr_lb[lane * p.B + s];
      const bool valid = a >= 0 && ok[k];
      addr[k] = a;
      // ①② label select + bypass decision
      const int wt = oracle ? owt[k] : c_wt[k];
      wlab[k] = wt;
      const bool probe = pi != 0 && (c_acc[k] % pi) == pi - 1;
      const float rand_u = static_cast<float>(hash_index(a, 7u, 65536u)) / 65536.0f;
      const int ph = st.pc_hits[pidx[k]], pa = st.pc_acc[pidx[k]], pr = st.pc_req[pidx[k]];
      const float pc_ratio = static_cast<float>(ph) / static_cast<float>(max(pa, 1));
      const bool pc_probe = (pr % 16) == 15;
      const bool cand[5] = {false, wt <= 1 && !probe, !tok[k],
                            pa > 32 && pc_ratio < 0.25f && !pc_probe, rand_u < rand_p};
      float sel = 0.f;
#pragma unroll
      for (int m = 0; m < 5; ++m) sel = sel + bsel[m] * (cand[m] ? 1.f : 0.f);
      const bool byp = sel > 0.5f && valid;
      use[k] = valid && !byp;

      // L2 lookup: first matching way; RRIP hit promotion
      const int si = hash_index(a, 2u, p.sets);
      sidx[k] = si;
      const int base = si * p.ways;
      int hw = -1;
      for (int w = 0; w < p.ways; ++w)
        if (hw < 0 && st.tags[base + w] == a) hw = w;
      hit[k] = hw >= 0 && use[k];
      hit_way[k] = hw;
      // ③ aging and victim: the first maximal way of the promoted row
      int mx = -2147483647 - 1;
      for (int w = 0; w < p.ways; ++w) {
        const int r = (hit[k] && w == hw) ? 0 : st.rrip[base + w];
        mx = max(mx, r);
      }
      int vic = 0;
      for (int w = p.ways - 1; w >= 0; --w) {
        const int r = (hit[k] && w == hw) ? 0 : st.rrip[base + w];
        if (r == mx) vic = w;
      }
      alloc[k] = use[k] && !hit[k];
      shift[k] = alloc[k] ? p.rrip_max - mx : 0;
      victim[k] = vic;
      const int evicted = st.tags[base + vic];
      const int vtype = st.meta[base + vic];
      // insertion rank: one-hot select over (lru, medic, eaf)
      const bool ebit = st.eaf[hash_index(a, 5u, p.eaf_bits)] == gen0;
      const int r_medic = wt >= 3 ? 0 : (wt == 2 ? p.rrip_max - 2 : p.rrip_max - 1);
      const int r_eaf = ebit ? 0 : p.rrip_max - 1;
      const float rsel = isel[0] * 0.f + isel[1] * static_cast<float>(r_medic) +
                         isel[2] * static_cast<float>(r_eaf);
      rank[k] = static_cast<int>(rintf(rsel));
      ev[k] = alloc[k] && evicted >= 0;
      eidx[k] = hash_index(evicted, 5u, p.eaf_bits);
      n_ev += ev[k];

      // ① classifier observe on this slot's rows
      c_hits[k] += hit[k] ? 1 : 0;
      c_acc[k] += valid ? 1 : 0;
      c_smp[k] += use[k] ? 1 : 0;
      const bool due = static_cast<float>(c_acc[k]) >= interval;
      const float ratio_now =
          static_cast<float>(c_hits[k]) / static_cast<float>(max(c_smp[k], 1));
      int t = 2;
      if (ratio_now <= p.mostly_miss) t = 1;
      if (ratio_now <= p.eps) t = 0;
      if (ratio_now >= p.mostly_hit) t = 3;
      if (ratio_now >= p.one_minus_eps) t = 4;
      if (!(static_cast<float>(c_smp[k]) >= min_samples)) t = 2;
      if (due && c_win[k] < max_windows) c_wt[k] = t;
      if (due) {
        c_ratio[k] = ratio_now;
        c_win[k] += 1;
        c_hits[k] = c_acc[k] = c_smp[k] = 0;
      }

      const int o = lane * p.B + s;
      rec.t[o] = t0[k] + static_cast<float>(lane) * p.lane_skew;
      rec.addr[o] = a;
      rec.valid[o] = valid;
      rec.byp[o] = byp;
      rec.use_l2[o] = use[k];
      rec.hit[o] = hit[k];
      rec.hp[o] = sched_medic && wt >= 3;
      rec.victim_type[o] = vtype;
      rec.ev_valid[o] = ev[k];
    }
    __syncthreads();

    // ---- 2. resolve: last writer per set, PC counters, eviction count ----
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int s = tid + k * blockDim.x;
      if (s >= p.B) continue;
      if (alloc[k]) atomicMax(&p_alloc[sidx[k]], s);
      if (use[k]) atomicMax(&p_rrip[sidx[k]], s);
      const bool valid = addr[k] >= 0 && ok[k];
      if (hit[k]) atomicAdd(&st.pc_hits[pidx[k]], 1);
      if (use[k]) atomicAdd(&st.pc_acc[pidx[k]], 1);
      if (valid) atomicAdd(&st.pc_req[pidx[k]], 1);
    }
    if (n_ev) atomicAdd(&s_nev, n_ev);
    __syncthreads();

    // ---- 3. write: winners only; EAF stamps; generation reset -------------
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int s = tid + k * blockDim.x;
      if (s >= p.B) continue;
      const int base = sidx[k] * p.ways;
      if (alloc[k] && p_alloc[sidx[k]] == s) {
        st.tags[base + victim[k]] = addr[k];
        st.meta[base + victim[k]] = wlab[k];
      }
      if (use[k] && p_rrip[sidx[k]] == s) {
        for (int w = 0; w < p.ways; ++w) {
          const int r = (hit[k] && w == hit_way[k]) ? 0 : st.rrip[base + w];
          st.rrip[base + w] = (alloc[k] && w == victim[k]) ? rank[k] : r + shift[k];
        }
      }
      if (ev[k]) st.eaf[eidx[k]] = gen0;
    }
    if (tid == 0) {
      const int ctr = s_ctr + s_nev;
      const bool reset = ctr >= p.eaf_capacity;
      s_gen = reset ? gen0 + 1 : gen0;
      s_ctr = reset ? 0 : ctr;
      s_nev = 0;
    }
    __syncthreads();

    // clear the pointer entries this lane touched (read phases of the next
    // lane never look at them; its resolve phase follows a barrier)
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      if (tid + k * blockDim.x >= p.B) continue;
      if (alloc[k]) p_alloc[sidx[k]] = -1;
      if (use[k]) p_rrip[sidx[k]] = -1;
    }
  }

#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int s = tid + k * blockDim.x;
    if (s >= p.B) continue;
    st.hits[s] = c_hits[k];
    st.acc[s] = c_acc[k];
    st.wtype[s] = c_wt[k];
    st.windows[s] = c_win[k];
    st.sampled[s] = c_smp[k];
    st.ratio[s] = c_ratio[k];
  }
  __syncthreads();
  if (tid == 0) {
    *st.eaf_gen = s_gen;
    *st.eaf_ctr = s_ctr;
  }
}

template <int SPT>
cudaError_t launch(int threads, size_t smem, cudaStream_t stream, const Params& p,
                   const Inputs& in, const State& st, const Records& rec) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wave_cache_kernel<SPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  wave_cache_kernel<SPT><<<1, threads, smem, stream>>>(p, in, st, rec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* wave_cache_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch one wave's cache pass on `stream`. Every pointer is a contiguous
// device buffer (bool as one byte). The state and classifier buffers are
// updated in place; the records [L, B] are written. Returns the cudaError_t
// of the launch.
int wave_cache_launch(int B, int L, int sets, int ways, int eaf_bits, int pc_entries,
                      int rrip_max, int eaf_capacity, float lane_skew,
                      float sampling_interval, float probe_interval, float mostly_hit,
                      float mostly_miss, float eps, float one_minus_eps, const void* addr_lb,
                      const void* pc_b, const void* owt_b, const void* slot_ok,
                      const void* tokens_b, const void* t0, const void* bypass_sel,
                      const void* ins_sel, const void* sched_medic, const void* rand_p,
                      const void* label_sel, const void* reclass_interval,
                      const void* pa_probe_interval, void* tags, void* rrip, void* meta,
                      void* eaf, void* eaf_gen, void* eaf_ctr, void* pc_hits, void* pc_acc,
                      void* pc_req, void* hits, void* acc, void* wtype, void* ratio,
                      void* windows, void* sampled, void* r_t, void* r_addr, void* r_valid,
                      void* r_byp, void* r_use, void* r_hit, void* r_hp, void* r_vt,
                      void* r_ev, void* stream) {
  if (B < 1 || L < 0 || sets < 1 || ways < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{B, L, sets, ways, eaf_bits, pc_entries, rrip_max, eaf_capacity,
           lane_skew, sampling_interval, probe_interval, mostly_hit, mostly_miss, eps,
           one_minus_eps};
  Inputs in{(const int*)addr_lb,   (const int*)pc_b,          (const int*)owt_b,
            (const uint8_t*)slot_ok, (const uint8_t*)tokens_b, (const float*)t0,
            (const float*)bypass_sel, (const float*)ins_sel,  (const float*)sched_medic,
            (const float*)rand_p,    (const float*)label_sel, (const float*)reclass_interval,
            (const float*)pa_probe_interval};
  State st{(int*)tags,    (int*)rrip,   (int*)meta,    (int*)eaf,     (int*)eaf_gen,
           (int*)eaf_ctr, (int*)pc_hits, (int*)pc_acc, (int*)pc_req,  (int*)hits,
           (int*)acc,     (int*)wtype,  (int*)windows, (int*)sampled, (float*)ratio};
  Records rec{(float*)r_t,       (int*)r_addr,     (uint8_t*)r_valid,
              (uint8_t*)r_byp,   (uint8_t*)r_use,  (uint8_t*)r_hit,
              (uint8_t*)r_hp,    (int*)r_vt,       (uint8_t*)r_ev};
  const int spt = (B + kMaxThreads - 1) / kMaxThreads;
  const int threads = spt == 1 ? ((B + 31) / 32) * 32 : kMaxThreads;
  const size_t smem = 2 * static_cast<size_t>(sets) * sizeof(int);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (spt == 1) e = launch<1>(threads, smem, s, p, in, st, rec);
  else if (spt == 2) e = launch<2>(threads, smem, s, p, in, st, rec);
  else if (spt <= 4) e = launch<4>(threads, smem, s, p, in, st, rec);
  else if (spt <= 8) e = launch<8>(threads, smem, s, p, in, st, rec);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // extern "C"
