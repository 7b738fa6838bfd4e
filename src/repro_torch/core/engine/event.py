"""Exact discrete-event engine (``engine="event"``), in torch.

True discrete-event order: each outer step pops the globally earliest
ready warp and services its next memory instruction's requests one at a
time, so every queue counter is updated chronologically (up to
intra-instruction lane skew). A torch form of
``repro.core.engine.event`` with an explicit leading simulation axis:
N = P·S independent simulations (one policy row and one trace seed
each) advance together, one batched op per step of the reference's
scalar loop, where the reference vmaps ``simulate_core``.

``event_loop`` is the plain version: an eager Python loop of I·W event
steps, each with L request steps. It is launch-bound (a few hundred
small ops a request step), which is why CUDA tensors go to the Hopper
kernel ``csrc/event_loop.cu`` instead (``kernels/event_loop``, gate
``backend``): one launch, one thread block per simulation, bitwise equal
to this loop. The loop owns its state and updates it in place.

Semantics kept exactly: the earliest-ready pop is an ``argmin`` with
ties to the lowest warp; the hit way and the victim are the first
matching / first maximal way; the victim's type is read before it is
overwritten; the EAF reset is a generation bump; the classifier observes
with the ``weight`` (valid) and ``probed`` (cache path) masks;
``qdelay_sum`` and ``stall_cycles`` add in request order.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch import spans as SP
from repro_torch.core import warp_types as WT
from repro_torch.core.classifier import ClassifierState
from repro_torch.core.engine import request as REQ
from repro_torch.core.engine.state import SimParams, SimState, init_state
from repro_torch.kernels.cache_pass import ref as _cache_ref
from repro_torch.policy import PolicyArrays, ops as POL

F32 = torch.float32
I32 = torch.int32

_INF = float("inf")


class ReqIndex(NamedTuple):
    """The pure-in-address indices of one request of each simulation
    ([N] each): L2 bank and set, DRAM channel and row, EAF slot, the
    tie-break draw, and the PC-table entry."""
    bank: torch.Tensor
    sidx: torch.Tensor
    ch: torch.Tensor
    row: torch.Tensor
    erd: torch.Tensor
    rand_u: torch.Tensor
    pidx: torch.Tensor


def request_index(addr, pc, prm: SimParams) -> ReqIndex:
    """``ReqIndex`` of addresses ``addr`` (any shape) issued by PCs
    ``pc`` (broadcast against ``addr``)."""
    return ReqIndex(
        bank=REQ.bank_index(addr, prm).long(),
        sidx=REQ.set_index(addr, prm).long(),
        ch=REQ.dram_channel(addr, prm).long(),
        row=REQ.dram_row(addr, prm),
        erd=REQ.eaf_index(addr, prm).long(),
        rand_u=REQ.hash_index(addr, 7, 65536).to(F32) / 65536.0,
        pidx=REQ.pc_index(pc, prm).long())


def _observe(clf: ClassifierState, sim, w, hit, weight, probed,
             prm: SimParams, oc: tuple) -> ClassifierState:
    """``classifier.observe`` of one request per simulation on the full
    [N, W] rows: the warp's counters take the request, then every warp
    whose window is full is re-classified (as the reference, which
    checks all W warps: with a window of at most 0 accesses every warp
    is due on every request). ``oc`` is the cache pass's
    ``observe_consts``: the [N] knobs of each simulation's policy."""
    interval, max_windows, min_samples = oc
    hits = clf.hits.index_put((sim, w), hit.to(I32) * probed,
                              accumulate=True)
    accesses = clf.accesses.index_put((sim, w), weight, accumulate=True)
    sampled = clf.sampled.index_put((sim, w), probed, accumulate=True)
    due = accesses >= interval[:, None]
    ratio_now = hits.to(F32) / torch.clamp_min(sampled, 1)
    new_type = WT.classify(ratio_now, sampled,
                           mostly_hit_threshold=prm.mostly_hit_threshold,
                           mostly_miss_threshold=prm.mostly_miss_threshold,
                           min_samples=min_samples[:, None])
    relabel = due & (clf.windows < max_windows[:, None])
    return ClassifierState(
        hits=torch.where(due, 0, hits),
        accesses=torch.where(due, 0, accesses),
        warp_type=torch.where(relabel, new_type, clf.warp_type),
        ratio=torch.where(due, ratio_now, clf.ratio),
        windows=clf.windows + due.to(I32),
        sampled=torch.where(due, 0, sampled))


def _step(st: SimState, req, ix: ReqIndex, prm: SimParams,
          pa: PolicyArrays, tokens, oc: tuple) -> tuple:
    """One request of each simulation against its full state, with the
    request's indices precomputed. Updates ``st``'s tensors in place;
    returns ``(st, t_done)``."""
    t_arr, w, addr, valid, owt = req
    sim = torch.arange(w.shape[0], device=w.device)
    m = st.metrics
    ways = torch.arange(prm.ways, device=w.device)[None, :]

    # ---- ①② label select + bypass decision ---------------------------------
    byp, wtype = REQ.bypass_decision_core(
        st.clf.warp_type[sim, w], st.clf.accesses[sim, w], tokens[sim, w],
        st.pc_hits[sim, ix.pidx], st.pc_acc[sim, ix.pidx],
        st.pc_req[sim, ix.pidx], addr, valid, prm, pa, owt,
        rand_u=ix.rand_u)
    use_l2 = valid & ~byp

    # ---- L2 bank queue (O3) ------------------------------------------------
    free = st.bank_free[sim, ix.bank]
    t_head = torch.maximum(free, t_arr)
    st.bank_free[sim, ix.bank] = torch.where(use_l2, t_head + prm.l2_svc,
                                             free)
    qdelay = torch.where(use_l2, t_head - t_arr, 0.0)

    # ---- L2 lookup -----------------------------------------------------------
    tset = st.tags[sim, ix.sidx]                        # [N, ways]
    is_line = tset == addr[:, None]
    hit = is_line.any(dim=1) & use_l2
    hit_way = torch.argmax(is_line.to(I32), dim=1)     # first match
    rset = st.rrip[sim, ix.sidx]
    rset = torch.where(hit[:, None] & (ways == hit_way[:, None]), 0, rset)

    # ---- ③ fill + insertion -------------------------------------------------
    allocate = use_l2 & ~hit
    shift = prm.rrip_max - rset.amax(dim=1)
    rset_aged = rset + torch.where(allocate, shift, 0)[:, None]
    victim = torch.argmax(rset_aged, dim=1)             # first max
    evicted = tset[sim, victim]
    victim_type = st.meta_type[sim, ix.sidx, victim]    # read BEFORE write
    rank = POL.insertion_rank(
        pa, wtype=wtype, eaf_bit=st.eaf[sim, ix.erd] == st.eaf_gen,
        rrip_max=prm.rrip_max)
    st.tags[sim, ix.sidx, victim] = torch.where(allocate, addr, evicted)
    st.rrip[sim, ix.sidx] = torch.where(
        allocate[:, None],
        torch.where(ways == victim[:, None], rank[:, None], rset_aged), rset)
    st.meta_type[sim, ix.sidx, victim] = torch.where(allocate, wtype,
                                                     victim_type)

    # EAF bookkeeping: the periodic reset is a generation bump
    ev_valid = allocate & (evicted >= 0)
    eidx = REQ.eaf_index(evicted, prm).long()
    st.eaf[sim, eidx] = torch.where(ev_valid, st.eaf_gen, st.eaf[sim, eidx])
    eaf_ctr = st.eaf_ctr + ev_valid.to(I32)
    reset = eaf_ctr >= prm.eaf_capacity
    st = st._replace(eaf_gen=torch.where(reset, st.eaf_gen + 1, st.eaf_gen),
                     eaf_ctr=torch.where(reset, 0, eaf_ctr))

    # ---- ④ DRAM two-queue FR-FCFS ------------------------------------------
    go_dram = valid & (byp | ~hit)
    t_dram_arr = torch.where(byp, t_arr, t_head + prm.l2_lat)
    cur = st.cur_row[sim, ix.ch]
    row_hit = (cur == ix.row) & go_dram
    occ, lat = REQ.dram_occ_lat(row_hit, prm)
    hp = POL.is_high_priority(pa, wtype)
    hpf, lpf = st.hp_free[sim, ix.ch], st.lp_free[sim, ix.ch]
    t0 = torch.where(hp, torch.maximum(hpf, t_dram_arr),
                     torch.maximum(torch.maximum(lpf, hpf), t_dram_arr))
    st.hp_free[sim, ix.ch] = torch.where(go_dram & hp, t0 + occ, hpf)
    st.lp_free[sim, ix.ch] = torch.where(go_dram & ~hp, t0 + occ, lpf)
    st.cur_row[sim, ix.ch] = torch.where(go_dram, ix.row, cur)

    t_done = torch.where(hit, t_head + prm.l2_lat, t0 + lat)
    t_done = torch.where(valid, t_done, t_arr)

    # ---- ① classifier + PC table + lifetime counters -------------------------
    valid_i, use_i, hit_i = valid.to(I32), use_l2.to(I32), hit.to(I32)
    clf = _observe(st.clf, sim, w, hit, valid_i, use_i, prm, oc)
    st.pc_hits.index_put_((sim, ix.pidx), hit_i, accumulate=True)
    st.pc_acc.index_put_((sim, ix.pidx), use_i, accumulate=True)
    st.pc_req.index_put_((sim, ix.pidx), valid_i, accumulate=True)
    st.tot_hits.index_put_((sim, w), hit_i, accumulate=True)
    st.tot_acc.index_put_((sim, w), valid_i, accumulate=True)

    # ---- metrics -------------------------------------------------------------
    m["qdelay_hist"].index_put_((sim, REQ.qdelay_bin(qdelay).long()), use_i,
                                accumulate=True)
    m["qdelay_sum"] += qdelay
    m["l2_accesses"] += use_i
    m["l2_hits"] += hit_i
    m["dram_accesses"] += go_dram.to(I32)
    m["row_hits"] += row_hit.to(I32)
    m["bypasses"] += byp.to(I32)
    m["evictions_by_type"].index_put_((sim, victim_type.long()),
                                      ev_valid.to(I32), accumulate=True)
    return st._replace(clf=clf), t_done


def _request_step(st: SimState, req, prm: SimParams, pa: PolicyArrays,
                  tokens) -> tuple:
    """Service ONE request of each of N simulations against its full
    state, chronologically exact. ``req`` is ``(t_arr, w, addr, pc,
    valid, oracle_wt)``, each [N]; ``st`` and ``pa`` carry the leading
    [N] axis and ``tokens`` is [N, W]. Updates ``st`` in place; returns
    ``(st, t_done)``."""
    t_arr, w, addr, pc, valid, owt = req
    return _step(st, (t_arr, w.long(), addr, valid, owt),
                 request_index(addr, pc, prm), prm, pa, tokens,
                 _cache_ref.observe_consts(prm, pa))


def batch_state(n: int, n_warps: int, prm: SimParams, device) -> SimState:
    """``init_state`` with a leading axis of ``n`` simulations."""
    def rep(x):
        return x.unsqueeze(0).repeat(n, *([1] * x.ndim))
    st = init_state(n_warps, prm, device)
    return SimState(
        clf=ClassifierState(*(rep(x) for x in st.clf)),
        metrics={k: rep(v) for k, v in st.metrics.items()},
        **{f: rep(getattr(st, f)) for f in SimState._fields
           if f not in ("clf", "metrics")})


class Bucket(NamedTuple):
    """One ``simulate_sweep`` call's inputs with the simulation axis
    spelled out: S trace seeds, P policies, N = P·S simulations, the
    simulation n = p·S + s running policy p on seed s."""
    lines: torch.Tensor     # i32[S, I, W, L]
    pcs: torch.Tensor       # i32[S, I, W]
    gap: torch.Tensor       # f32[S, I] (a constant gap repeated)
    oracle: torch.Tensor    # i32[S, I, W]
    pa: PolicyArrays        # one row per simulation, [N, ...]
    tokens: torch.Tensor    # bool[N, W]
    seed_of: torch.Tensor   # i64[N] the trace of each simulation


def bucket(trace_lines, trace_pcs, compute_gap, oracle_types,
           pa: PolicyArrays, n_warps: int) -> Bucket:
    """The loop's inputs for P stacked policy rows over seed-stacked
    traces [S, ...] (``compute_gap`` [S] or [S, I])."""
    s, n_instr = trace_lines.shape[0], trace_lines.shape[1]
    p = pa.rand_p.shape[0]
    pol_of = torch.arange(p, device=trace_lines.device).repeat_interleave(s)
    pa_n = PolicyArrays(*(leaf[pol_of] for leaf in pa))
    tokens = POL.pcal_tokens(
        pa_n._replace(pcal_frac=pa_n.pcal_frac[:, None]), n_warps)
    gap = compute_gap if compute_gap.ndim == 2 \
        else compute_gap[:, None].expand(s, n_instr)
    return Bucket(lines=trace_lines.contiguous(),
                  pcs=trace_pcs.contiguous(), gap=gap.contiguous(),
                  oracle=oracle_types.contiguous(), pa=pa_n, tokens=tokens,
                  seed_of=torch.arange(s, device=trace_lines.device)
                  .repeat(p))


def event_loop(b: Bucket, *, n_warps: int, lanes: int,
               prm: SimParams) -> tuple:
    """The plain version: I·W event steps for all N simulations at once.
    Returns ``(st, ready, ptr, ratio_t)``: the final state [N, ...], the
    ready times and instruction pointers [N, W], and the ratio snapshot
    taken after each instruction, [N, I, W]."""
    dev = b.lines.device
    n, n_instr = b.seed_of.shape[0], b.lines.shape[1]
    sim = torch.arange(n, device=dev)
    oc = _cache_ref.observe_consts(prm, b.pa)
    st = batch_state(n, n_warps, prm, dev)
    ready = torch.zeros((n, n_warps), dtype=F32, device=dev)
    ptr = torch.zeros((n, n_warps), dtype=torch.long, device=dev)
    ratio_t = torch.zeros((n, n_instr, n_warps), dtype=F32, device=dev)
    # lane * lane_skew in float32, as the reference's f32 lane index
    skew = [float(np.float32(k) * np.float32(prm.lane_skew))
            for k in range(lanes)]
    for _ in range(n_instr * n_warps):
        active = ptr < n_instr
        w = torch.argmin(torch.where(active, ready, _INF), dim=1)
        i = ptr[sim, w]
        lines = b.lines[b.seed_of, i, w]                # [N, L]
        pc = b.pcs[b.seed_of, i, w]
        owt = b.oracle[b.seed_of, i, w]
        t0 = ready[sim, w]
        valid = lines >= 0
        ix = request_index(lines, pc[:, None], prm)
        dones = []
        for k in range(lanes):
            st, done = _step(
                st, (t0 + skew[k], w, lines[:, k], valid[:, k], owt),
                ReqIndex(*(a[:, k] for a in ix[:-1]), ix.pidx[:, 0]),
                prm, b.pa, b.tokens, oc)
            dones.append(done)
        dones = torch.stack(dones, dim=1)
        dmax = torch.where(valid, dones, -_INF).amax(dim=1)
        dmin = torch.where(valid, dones, _INF).amin(dim=1)
        has_req = torch.isfinite(dmax)
        st.metrics["stall_cycles"] += torch.where(has_req, dmax - dmin, 0.0)
        gap = b.gap[b.seed_of, i]
        ready[sim, w] = torch.where(has_req, dmax + gap, t0 + gap)
        ptr[sim, w] = i + 1
        # snapshot for Fig 4: the sampled ratio after the instruction
        ratio_t[sim, i, w] = st.clf.ratio[sim, w]
    return st, ready, ptr.to(I32), ratio_t


def state_row(st: SimState, n: int) -> SimState:
    """Simulation ``n`` of a batched state."""
    return SimState(
        clf=ClassifierState(*(x[n] for x in st.clf)),
        metrics={k: v[n] for k, v in st.metrics.items()},
        **{f: getattr(st, f)[n] for f in SimState._fields
           if f not in ("clf", "metrics")})


def finalize_bucket(st: SimState, ready, ratio_t, compute_gap, *,
                    n_instr: int, n_warps: int,
                    prm: SimParams) -> Dict[str, Any]:
    """``request.finalize_outputs`` of each of the N = P·S simulations of
    a loop's result (``compute_gap`` [S] or [S, I]; simulation n ran seed
    n % S), stacked on a leading [N] axis."""
    n_seeds = compute_gap.shape[0]
    outs = [REQ.finalize_outputs(state_row(st, n), ready[n], ratio_t[n],
                                 compute_gap[n % n_seeds], n_instr=n_instr,
                                 n_warps=n_warps, prm=prm)
            for n in range(ready.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def simulate_core(trace_lines, trace_pcs, compute_gap, oracle_types,
                  pa: PolicyArrays, *, n_warps: int, lanes: int,
                  prm: SimParams, backend: str = "auto") -> Dict[str, Any]:
    """P policies × S seeds on the event engine, in one loop.

    trace_lines: i32[S, I, W, L]; trace_pcs, oracle_types: i32[S, I, W];
    compute_gap: f32[S] or f32[S, I]; ``pa`` stacked [P, ...]. Every
    tensor on one device. The loop runs under the ``backend`` gate
    (``kernels.event_loop``: the Hopper kernel for CUDA tensors, this
    module's ``event_loop`` for CPU ones). Returns the metrics dict with
    a leading axis N = P·S (simulation n = p·S + s)."""
    from repro_torch.kernels.event_loop import ops as EVL
    with SP.span("event.loop"):
        b = bucket(trace_lines, trace_pcs, compute_gap, oracle_types, pa,
                   n_warps)
        st, ready, _, ratio_t = EVL.event_loop(
            b, n_warps=n_warps, lanes=lanes, prm=prm, backend=backend)
    with SP.span("event.finalize"):
        return finalize_bucket(st, ready, ratio_t, compute_gap,
                               n_instr=trace_lines.shape[1],
                               n_warps=n_warps, prm=prm)
