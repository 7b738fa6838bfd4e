"""Plain PyTorch wavefront cache pass: the per-lane sequential loop.

A torch form of ``repro.kernels.cache_pass.ref``. One wave of B warps
runs L lane sub-steps; each lane services at most ONE request per warp,
[B]-vectorized, slots in chronological order:

  * ②  bypass decision from the carried classifier rows + PC table,
  * L2 tag lookup against the lane-start tags,
  * ③  RRIP fill/aging/eviction,
  * EAF and PC-table bookkeeping,
  * ①  the classifier observe on wave-resident [B] counter slices
    (``observe_vec``; the engine gathers the rows once per wave and
    scatters them back once — sound because wave warp ids are distinct).

Every lane reads its decisions from lane-start state, then writes. Two
slots of one lane may write the same cache set; the reference resolves
that last-write-wins in slot order (XLA applies duplicate scatter updates
in operand order). Here the winner is explicit: a ``scatter_reduce`` of
the slot index with ``amax`` per set, on two chains — tags and meta
advance on ``allocate``, RRIP rows on ``use_l2`` — and only the winners
write a kept row, so no kept index is written twice; the other writes go
to a parking row that is dropped. Same-lane allocators of one set
share the lane-start RRIP row, hence the victim way, so the per-set
winner is also the per-element winner. Integer adds into the PC tables
use ``index_add_`` (exact in any order); every EAF write of a lane stores
the same lane-start generation.

This is the CPU path of ``ops.wave_cache_pass`` and the plain version
``chip_smoke.py`` holds the CUDA kernel against, bitwise.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import classifier as CLF
from repro_torch.core import warp_types as WT
from repro_torch.core.engine import request as REQ
from repro_torch.core.engine.state import (CACHE_FIELDS as _CACHE_FIELDS,
                                           SimParams, SimState)
from repro_torch.policy import PolicyArrays, ops as POL

F32 = torch.float32
I32 = torch.int32


def observe_consts(prm: SimParams, pa: PolicyArrays) -> tuple:
    """The policy-only observe scalars ``(interval, max_windows,
    min_samples)``, pure in ``(prm, pa)``."""
    interval = POL.reclass_interval(pa, prm.sampling_interval)
    max_windows = POL.reclass_max_windows(pa)
    min_samples = CLF.min_probe_samples(
        interval, POL.probe_interval(pa, prm.probe_interval))
    return interval, max_windows, min_samples


def observe_vec(clf_b: CLF.ClassifierState, is_hit, weight, probed,
                prm: SimParams, pa: PolicyArrays,
                consts: Optional[tuple] = None) -> CLF.ClassifierState:
    """``classifier.observe`` on wave-resident [B] counter slices: the
    slots' warps are distinct, so the [B] rows are exactly what a gather
    from the [W] arrays would return."""
    interval, max_windows, min_samples = (
        observe_consts(prm, pa) if consts is None else consts)
    hits = clf_b.hits + is_hit.to(I32) * probed
    accesses = clf_b.accesses + weight
    sampled = clf_b.sampled + probed
    due = accesses >= interval
    ratio_now = hits.to(F32) / torch.clamp_min(sampled, 1)
    new_type = WT.classify(ratio_now, sampled,
                           mostly_hit_threshold=prm.mostly_hit_threshold,
                           mostly_miss_threshold=prm.mostly_miss_threshold,
                           min_samples=min_samples)
    relabel = due & (clf_b.windows < max_windows)
    return CLF.ClassifierState(
        hits=torch.where(due, 0, hits),
        accesses=torch.where(due, 0, accesses),
        warp_type=torch.where(relabel, new_type, clf_b.warp_type),
        ratio=torch.where(due, ratio_now, clf_b.ratio),
        windows=clf_b.windows + due.to(I32),
        sampled=torch.where(due, 0, sampled))


def _winners(key, write, slot, n_keys):
    """Slots that win their key: among the writing slots of each key, the
    one with the largest slot index (last write in slot order)."""
    parked = torch.where(write, key, n_keys).long()
    win = torch.full((n_keys + 1,), -1, dtype=I32, device=key.device)
    win.scatter_reduce_(0, parked, slot, reduce="amax")
    return write & (win[parked] == slot)


def lane_cache_step(st: SimState, t_arr, addr, valid, owt,
                    prm: SimParams, pa: PolicyArrays,
                    clf_b: CLF.ClassifierState, tokens_b, *, sidx, erd,
                    rand_u, pidx, consts) -> tuple:
    """One lane sub-step of a wave for [B] requests (at most one per
    warp), slots in chronological order. Returns ``(st, clf_b, record)``.

    The pure-in-address draws (``sidx`` set index, ``erd`` EAF index,
    ``rand_u`` bypass draw), the PC-table index of each slot and the
    observe constants come precomputed (``wave_cache_pass_ref`` computes
    them once per wave, as the reference's fused sweep does). Writes go
    into ``st``'s cache and PC arrays IN PLACE (the caller owns them).
    ``st.tags``/``rrip``/``meta_type`` carry one parking row and
    ``st.eaf`` one parking entry past the end: every write the reference
    drops (``mode="drop"``) or loses to a later slot lands there, so no
    kept index is written twice and no host sync is needed."""
    dev = addr.device
    slot = torch.arange(addr.shape[0], dtype=I32, device=dev)
    ways = torch.arange(prm.ways, device=dev)[None, :]
    # ---- ①② label select + bypass decision (shared branchless math) --------
    byp, wtype = REQ.bypass_decision_core(
        clf_b.warp_type, clf_b.accesses, tokens_b, st.pc_hits[pidx],
        st.pc_acc[pidx], st.pc_req[pidx], addr, valid, prm, pa, owt,
        rand_u=rand_u)
    use_l2 = valid & ~byp

    # ---- L2 lookup (lane-start tags) ---------------------------------------
    tset = st.tags[sidx]                               # [B, ways]
    is_line = tset == addr[:, None]
    hit = is_line.any(dim=1) & use_l2
    hit_way = torch.argmax(is_line.to(I32), dim=1)    # first match
    rset = st.rrip[sidx]
    rset = torch.where(hit[:, None] & (ways == hit_way[:, None]), 0, rset)

    # ---- ③ fill + insertion -------------------------------------------------
    allocate = use_l2 & ~hit
    shift = prm.rrip_max - rset.amax(dim=1)
    rset_aged = rset + torch.where(allocate, shift, 0)[:, None]
    victim = torch.argmax(rset_aged, dim=1)            # first max
    evicted = tset.gather(1, victim[:, None])[:, 0]
    victim_type = st.meta_type[sidx, victim]           # read BEFORE overwrite
    rank = POL.insertion_rank(pa, wtype=wtype, eaf_bit=st.eaf[erd]
                              == st.eaf_gen, rrip_max=prm.rrip_max)
    new_row = torch.where(allocate[:, None],
                          torch.where(ways == victim[:, None],
                                      rank[:, None], rset_aged), rset)
    ev_valid = allocate & (evicted >= 0)
    eidx = REQ.eaf_index(evicted, prm).long()
    eaf_gen = st.eaf_gen.clone()

    # ---- explicit last-write-wins, then conflict-free writes ---------------
    w_alloc = _winners(sidx, allocate, slot, prm.sets)
    w_rrip = _winners(sidx, use_l2, slot, prm.sets)
    at_alloc = torch.where(w_alloc, sidx, prm.sets)
    st.tags[at_alloc, victim] = addr
    st.meta_type[at_alloc, victim] = wtype
    st.rrip[torch.where(w_rrip, sidx, prm.sets)] = new_row
    st.eaf[torch.where(ev_valid, eidx, prm.eaf_bits)] = eaf_gen

    # EAF counter: the periodic reset is a generation bump (state.py)
    eaf_ctr = st.eaf_ctr + ev_valid.sum(dtype=I32)
    reset = eaf_ctr >= prm.eaf_capacity
    st.eaf_gen.copy_(torch.where(reset, eaf_gen + 1, eaf_gen))
    st.eaf_ctr.copy_(torch.where(reset, 0, eaf_ctr))

    # ---- ① classifier + PC table (read by later lanes) ---------------------
    valid_i, use_i = valid.to(I32), use_l2.to(I32)
    clf_b = observe_vec(clf_b, hit, valid_i, use_i, prm, pa, consts)
    st.pc_hits.index_add_(0, pidx, hit.to(I32))        # hit implies use_l2
    st.pc_acc.index_add_(0, pidx, use_i)
    st.pc_req.index_add_(0, pidx, valid_i)

    hp = POL.is_high_priority(pa, wtype)
    return st, clf_b, (t_arr, addr, valid, byp, use_l2, hit, hp,
                       victim_type, ev_valid)


_PARKED = ("tags", "rrip", "meta_type", "eaf")


def _parked(x):
    """A copy of ``x`` with one parking row (entry) past the end."""
    return torch.cat([x, x[:1]])


def wave_cache_pass_ref(st: SimState, clf_b0: CLF.ClassifierState,
                        tokens_b, t0, addr_lb, pc_b, owt_b, slot_ok,
                        prm: SimParams, pa: PolicyArrays) -> tuple:
    """One wave's full cache pass: the L-lane loop.

    ``addr_lb`` is i32[L, B] (lane-major); ``t0``/``pc_b``/``owt_b``/
    ``slot_ok``/``tokens_b`` are per-slot [B]. Returns ``(st, clf_b,
    records)`` with each record stacked [L, B]. ``st`` itself is not
    modified: its cache and PC arrays are copied once (the cache arrays
    with a parking row, see ``lane_cache_step``) and updated in place
    lane by lane.
    """
    work = st._replace(**{f: _parked(getattr(st, f)) if f in _PARKED
                          else getattr(st, f).clone() for f in _CACHE_FIELDS})
    # pure in (address, pc, policy): computed once for the whole wave
    sidx_lb = REQ.set_index(addr_lb, prm).long()
    erd_lb = REQ.eaf_index(addr_lb, prm).long()
    rand_lb = REQ.hash_index(addr_lb, 7, 65536).to(F32) / 65536.0
    pidx = REQ.pc_index(pc_b, prm).long()
    consts = observe_consts(prm, pa)
    clf_b = clf_b0
    recs = []
    for lane in range(addr_lb.shape[0]):
        addr = addr_lb[lane]
        valid = (addr >= 0) & slot_ok
        # lane * lane_skew in float32, as the reference's f32 lane index
        t_arr = t0 + float(np.float32(lane) * np.float32(prm.lane_skew))
        work, clf_b, rec = lane_cache_step(
            work, t_arr, addr, valid, owt_b, prm, pa, clf_b, tokens_b,
            sidx=sidx_lb[lane], erd=erd_lb[lane], rand_u=rand_lb[lane],
            pidx=pidx, consts=consts)
        recs.append(rec)
    st = work._replace(**{f: getattr(work, f)[:-1] for f in _PARKED})
    return st, clf_b, tuple(torch.stack(r) for r in zip(*recs))
