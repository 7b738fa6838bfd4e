"""Plain wavefront simulation of one (trace, policy) pair, the
benchmark's reference for the wavefront engine's cells.

A frozen copy of the program's plain PyTorch wavefront engine (one warp
shard), importing nothing of the program: each wave takes the
``wave_size`` earliest-ready warps (a stable sort of their ready times,
ties by warp id) and services their B x L requests in two passes. The
cache pass walks the L lanes, each lane's decisions read from
lane-start state, same-set writes resolved last-write-wins in slot
order. The timing pass recovers every queue's FIFO service times by
segmented prefix scans over the wave's requests in warp-major order,
with the work-conserving backlog floor carried between waves. It runs
on any device, in the timing precision ``ft`` (float32 for the
reference; bfloat16 for the lower-precision control).
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import numpy as np
import torch

I32 = torch.int32
ALL_MISS, MOSTLY_MISS, BALANCED, MOSTLY_HIT, ALL_HIT = range(5)
NUM_TYPES = 5
_EPS = 1e-6
_NEG = float("-inf")
_QEDGES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
_BYPASS = ("none", "medic", "pcal", "pcbyp", "rand")
_INSERT = ("lru", "medic", "eaf")
_LABEL = ("online", "stale", "oracle")
PC_PROBE_INTERVAL = 16


def hash_index(x, salt: int, mod: int):
    """Knuth multiplicative hash of ``x`` (as uint32) into [0, mod)."""
    u = torch.as_tensor(x).to(torch.int64) & 0xFFFFFFFF
    lo, hi = u & 0xFFFF, u >> 16
    h = (lo * 2654435761 + (((hi * 2654435761) & 0xFFFF) << 16)) \
        & 0xFFFFFFFF
    h = (h + ((salt * 0x9E3779B9) & 0xFFFFFFFF)) & 0xFFFFFFFF
    h = h ^ (h >> 15)
    return (h % mod).to(I32)


def classify(r, samples, min_samples, prm):
    t = torch.full(r.shape, BALANCED, dtype=I32, device=r.device)
    t = torch.where(r <= prm["mostly_miss_threshold"], MOSTLY_MISS, t)
    t = torch.where(r <= _EPS, ALL_MISS, t)
    t = torch.where(r >= prm["mostly_hit_threshold"], MOSTLY_HIT, t)
    t = torch.where(r >= 1.0 - _EPS, ALL_HIT, t)
    return torch.where(samples >= min_samples, t, BALANCED)


class Policy(NamedTuple):
    """One policy row as float32 tensors (one-hot selects, knobs)."""
    bypass_sel: torch.Tensor
    ins_sel: torch.Tensor
    sched_medic: torch.Tensor
    rand_p: torch.Tensor
    pcal_frac: torch.Tensor
    label_sel: torch.Tensor
    reclass_interval: torch.Tensor
    probe_interval: torch.Tensor


def policy_row(p: Mapping, device) -> Policy:
    def hot(menu, k):
        t = torch.zeros(len(menu), dtype=torch.float32, device=device)
        t[menu.index(k)] = 1.0
        return t

    def s(x):
        return torch.tensor(float(x), dtype=torch.float32, device=device)
    return Policy(hot(_BYPASS, p["bypass"]), hot(_INSERT, p["insertion"]),
                  s(p["scheduler"] == "medic"), s(p["rand_p"]),
                  s(p["pcal_frac"]), hot(_LABEL, p["labeling"]),
                  s(p["reclass_interval"]), s(p["probe_interval"]))


def _select(sel, cand):
    return torch.tensordot(sel, torch.stack(cand).to(torch.float32), dims=1)


def _probe_iv(pa, prm):
    return torch.where(pa.probe_interval > 0.5, pa.probe_interval,
                       float(prm["probe_interval"]))


def bypass_decision(pa, prm, wtype, accesses, token, pc_hits, pc_acc,
                    pc_req, valid, rand_u):
    pi = _probe_iv(pa, prm).to(I32)
    probe = (accesses % pi) == pi - 1
    pc_ratio = pc_hits / torch.clamp_min(pc_acc, 1)
    pc_probe = (pc_req % PC_PROBE_INTERVAL) == PC_PROBE_INTERVAL - 1
    cand = [torch.zeros(wtype.shape, dtype=torch.bool, device=wtype.device),
            (wtype <= MOSTLY_MISS) & ~probe, ~token,
            (pc_acc > 32) & (pc_ratio < 0.25) & ~pc_probe,
            rand_u < pa.rand_p]
    return (_select(pa.bypass_sel, cand) > 0.5) & valid


def insertion_rank(pa, wtype, eaf_bit, rrip_max: int):
    top = rrip_max - 1
    r_medic = torch.full(wtype.shape, top, dtype=I32, device=wtype.device)
    r_medic = torch.where(wtype == BALANCED, top - 1, r_medic)
    r_medic = torch.where(wtype >= MOSTLY_HIT, 0, r_medic)
    cand = [torch.zeros(wtype.shape, dtype=I32, device=wtype.device),
            r_medic, torch.where(eaf_bit, 0, rrip_max - 1).to(I32)]
    return torch.round(_select(pa.ins_sel, cand)).to(I32)


class Clf(NamedTuple):
    hits: torch.Tensor
    accesses: torch.Tensor
    warp_type: torch.Tensor
    ratio: torch.Tensor
    windows: torch.Tensor
    sampled: torch.Tensor


def observe_consts(pa, prm):
    interval = torch.where(pa.reclass_interval > 0.5, pa.reclass_interval,
                           float(prm["sampling_interval"]))
    max_windows = torch.where(pa.label_sel[1] > 0.5, 1, 1 << 30).to(I32)
    probe = _probe_iv(pa, prm)
    floor = torch.div(interval, torch.clamp_min(probe, 1.0),
                      rounding_mode="floor")
    return interval, max_windows, torch.clamp(floor, 1.0, 8.0)


def observe(c: Clf, hit, weight, probed, prm, consts) -> Clf:
    interval, max_windows, min_samples = consts
    hits = c.hits + hit.to(I32) * probed
    accesses = c.accesses + weight
    sampled = c.sampled + probed
    due = accesses >= interval
    ratio_now = hits.to(torch.float32) / torch.clamp_min(sampled, 1)
    new_type = classify(ratio_now, sampled, min_samples, prm)
    relabel = due & (c.windows < max_windows)
    return Clf(hits=torch.where(due, 0, hits),
               accesses=torch.where(due, 0, accesses),
               warp_type=torch.where(relabel, new_type, c.warp_type),
               ratio=torch.where(due, ratio_now, c.ratio),
               windows=c.windows + due.to(I32),
               sampled=torch.where(due, 0, sampled))


def _winners(key, write, slot, n_keys):
    parked = torch.where(write, key, n_keys).long()
    win = torch.full((n_keys + 1,), -1, dtype=I32, device=key.device)
    win.scatter_reduce_(0, parked, slot, reduce="amax")
    return write & (win[parked] == slot)


def cache_pass(st: dict, clf_b: Clf, tokens_b, t0, addr_lb, pc_b, owt_b,
               slot_ok, prm, pa, ft):
    """One wave's cache pass over its L lanes. ``st`` holds the cache
    and PC arrays (updated in place, the cache arrays with one parking
    row past the end). Returns ``(clf_b, records [L, B] each)``."""
    dev = addr_lb.device
    sets, ways_n = prm["sets"], prm["ways"]
    slot = torch.arange(addr_lb.shape[1], dtype=I32, device=dev)
    ways = torch.arange(ways_n, device=dev)[None, :]
    sidx_lb = hash_index(addr_lb, 2, sets).long()
    erd_lb = hash_index(addr_lb, 5, prm["eaf_bits"]).long()
    rand_lb = hash_index(addr_lb, 7, 65536).to(torch.float32) / 65536.0
    pidx = hash_index(pc_b, 3, prm["pc_entries"]).long()
    consts = observe_consts(pa, prm)
    use_oracle = pa.label_sel[2] > 0.5
    recs = []
    for lane in range(addr_lb.shape[0]):
        addr = addr_lb[lane]
        sidx, erd = sidx_lb[lane], erd_lb[lane]
        valid = (addr >= 0) & slot_ok
        t_arr = t0 + float(np.float32(lane) * np.float32(prm["lane_skew"]))
        wtype = torch.where(use_oracle, owt_b, clf_b.warp_type)
        byp = bypass_decision(pa, prm, wtype, clf_b.accesses, tokens_b,
                              st["pc_hits"][pidx], st["pc_acc"][pidx],
                              st["pc_req"][pidx], valid, rand_lb[lane])
        use_l2 = valid & ~byp
        tset = st["tags"][sidx]
        is_line = tset == addr[:, None]
        hit = is_line.any(dim=1) & use_l2
        hit_way = torch.argmax(is_line.to(I32), dim=1)
        rset = st["rrip"][sidx]
        rset = torch.where(hit[:, None] & (ways == hit_way[:, None]), 0, rset)
        allocate = use_l2 & ~hit
        shift = prm["rrip_max"] - rset.amax(dim=1)
        rset_aged = rset + torch.where(allocate, shift, 0)[:, None]
        victim = torch.argmax(rset_aged, dim=1)
        evicted = tset.gather(1, victim[:, None])[:, 0]
        victim_type = st["meta_type"][sidx, victim]
        rank = insertion_rank(pa, wtype, st["eaf"][erd] == st["eaf_gen"],
                              prm["rrip_max"])
        new_row = torch.where(allocate[:, None],
                              torch.where(ways == victim[:, None],
                                          rank[:, None], rset_aged), rset)
        ev_valid = allocate & (evicted >= 0)
        eidx = hash_index(evicted, 5, prm["eaf_bits"]).long()
        eaf_gen = st["eaf_gen"].clone()
        w_alloc = _winners(sidx, allocate, slot, sets)
        w_rrip = _winners(sidx, use_l2, slot, sets)
        at_alloc = torch.where(w_alloc, sidx, sets)
        st["tags"][at_alloc, victim] = addr
        st["meta_type"][at_alloc, victim] = wtype
        st["rrip"][torch.where(w_rrip, sidx, sets)] = new_row
        st["eaf"][torch.where(ev_valid, eidx, prm["eaf_bits"])] = eaf_gen
        eaf_ctr = st["eaf_ctr"] + ev_valid.sum(dtype=I32)
        reset = eaf_ctr >= prm["eaf_capacity"]
        st["eaf_gen"].copy_(torch.where(reset, eaf_gen + 1, eaf_gen))
        st["eaf_ctr"].copy_(torch.where(reset, 0, eaf_ctr))
        valid_i, use_i = valid.to(I32), use_l2.to(I32)
        clf_b = observe(clf_b, hit, valid_i, use_i, prm, consts)
        st["pc_hits"].index_add_(0, pidx, hit.to(I32))
        st["pc_acc"].index_add_(0, pidx, use_i)
        st["pc_req"].index_add_(0, pidx, valid_i)
        hp = (pa.sched_medic > 0.5) & (wtype >= MOSTLY_HIT)
        recs.append((t_arr.to(ft), addr, valid, byp, use_l2, hit, hp,
                     victim_type, ev_valid))
    return clf_b, tuple(torch.stack(r) for r in zip(*recs))


def _carry_floor(free, last_ts, last_sa, t_s, t_svc):
    backlog = (free - last_sa)[:, None]
    interp = torch.minimum(free[:, None], t_svc[None, :] + backlog)
    return torch.where(t_s[None, :] >= last_ts[:, None], free[:, None],
                       interp)


def _anchor(last, mask, t):
    return torch.maximum(last,
                         torch.where(mask, t[None, :], _NEG).amax(dim=1))


def _prefix(mask, t_arr, occ, free):
    occ_m = torch.where(mask, occ[None, :], 0.0)
    c = torch.cumsum(occ_m, dim=1) - occ_m
    v = torch.where(mask, torch.maximum(t_arr[None, :], free) - c, _NEG)
    start = c + torch.cummax(v, dim=1).values
    end = torch.where(mask, start + occ_m, _NEG)
    return start, end


def timing_pass(q: dict, recs, prm, ft):
    """One wave's queue recovery over its B x L requests in warp-major
    order; updates the queue carry ``q`` and returns ``(t_done [L, B],
    qdelay, use_l2, go_dram, row_hit)`` flattened to [N]."""
    t_s, addr, valid, byp, use_l2, hit, hp = \
        [x.transpose(0, 1).reshape(-1) for x in recs[:7]]
    exact = recs[0].shape[1] == 1
    dev, n = t_s.device, t_s.shape[0]
    banks, chans = prm["banks"], prm["dram_channels"]
    bank = hash_index(addr, 1, banks)
    row = torch.div(addr, prm["row_lines"], rounding_mode="floor").to(I32)
    ch = hash_index(row, 4, chans)
    go_dram = valid & (byp | ~hit)
    slot = torch.arange(n, dtype=I32, device=dev)

    def floor(free, last_ts, last_sa, t_svc):
        if exact:
            return free[:, None]
        return _carry_floor(free, last_ts, last_sa, t_s, t_svc)

    bmask = (bank[None, :] == torch.arange(banks, dtype=I32,
                                           device=dev)[:, None]) \
        & use_l2[None, :]
    svc = torch.full((n,), prm["l2_svc"], dtype=ft, device=dev)
    b_start, b_end = _prefix(bmask, t_s, svc,
                             floor(q["bank_free"], q["bank_ts"],
                                   q["bank_ts"], t_s))
    t_head = torch.where(bmask, b_start, 0.0).sum(dim=0)
    bank_free = torch.maximum(q["bank_free"], b_end.amax(dim=1))
    t_da = torch.where(byp, t_s, t_head + prm["l2_lat"])
    cmask = (ch[None, :] == torch.arange(chans, dtype=I32,
                                         device=dev)[:, None]) \
        & go_dram[None, :]
    inc = torch.cummax(torch.where(cmask, slot[None, :], -1), dim=1).values
    prev_idx = torch.cat([torch.full((chans, 1), -1, dtype=I32, device=dev),
                          inc[:, :-1]], dim=1)
    prev_row = torch.where(prev_idx >= 0, row[prev_idx.clamp_min(0).long()],
                           q["cur_row"][:, None])
    own = ch.long()[None, :]
    row_hit = (prev_row == row[None, :]).gather(0, own)[0] & go_dram
    occ = torch.where(row_hit, prm["occ_rowhit"],
                      prm["occ_rowmiss"]).to(ft)
    mask_hp = cmask & hp[None, :]
    hp_carry = floor(q["hp_free"], q["hp_ts"], q["hp_sa"], t_da)
    hp_start, hp_end = _prefix(mask_hp, t_da, occ, hp_carry)
    hp_busy = torch.cat([torch.full((chans, 1), _NEG, dtype=ft, device=dev),
                         torch.cummax(hp_end, dim=1).values[:, :-1]], dim=1)
    lp_floor = torch.maximum(floor(q["lp_free"], q["lp_ts"], q["lp_sa"],
                                   t_da), torch.maximum(hp_carry, hp_busy))
    mask_lp = cmask & ~hp[None, :]
    lp_start, lp_end = _prefix(mask_lp, t_da, occ, lp_floor)
    t0 = torch.where(hp, hp_start.gather(0, own)[0],
                     lp_start.gather(0, own)[0])
    last_idx = inc[:, -1]
    q.update(
        bank_free=bank_free, bank_ts=_anchor(q["bank_ts"], bmask, t_s),
        hp_free=torch.maximum(q["hp_free"], hp_end.amax(dim=1)),
        hp_ts=_anchor(q["hp_ts"], mask_hp, t_s),
        hp_sa=_anchor(q["hp_sa"], mask_hp, t_da),
        lp_free=torch.maximum(q["lp_free"], lp_end.amax(dim=1)),
        lp_ts=_anchor(q["lp_ts"], mask_lp, t_s),
        lp_sa=_anchor(q["lp_sa"], mask_lp, t_da),
        cur_row=torch.where(last_idx >= 0,
                            row[last_idx.clamp_min(0).long()],
                            q["cur_row"]))
    qdelay = torch.where(use_l2, t_head - t_s, 0.0)
    lat = torch.where(row_hit, prm["t_rowhit"], prm["t_rowmiss"]).to(ft)
    t_done = torch.where(hit, t_head + prm["l2_lat"], t0 + lat)
    t_done = torch.where(valid, t_done, t_s)
    lanes, b = recs[0].shape
    return (t_done.reshape(b, lanes).transpose(0, 1), qdelay, use_l2,
            go_dram, row_hit)


def simulate(lines: np.ndarray, pcs: np.ndarray, gap, oracle: np.ndarray,
             policy: Mapping, prm: Mapping, wave_size: int, device,
             ft=torch.float32) -> Dict[str, object]:
    """One simulation: ``lines`` i32[I, W, L], ``pcs`` and ``oracle``
    i32[I, W], ``gap`` the compute gap (a number). Returns the scalar
    outputs ``event_sim.compare`` reads."""
    dev = torch.device(device)
    n_instr, n_warps, _ = lines.shape
    pa = policy_row(policy, dev)
    lines_wi = torch.as_tensor(lines).to(dev).transpose(0, 1)
    pcs_wi = torch.as_tensor(pcs).to(dev).transpose(0, 1)
    orc_wi = torch.as_tensor(oracle).to(dev).transpose(0, 1)
    n_tok = torch.clamp_min(torch.round(pa.pcal_frac * n_warps), 1).to(I32)
    tokens = hash_index(torch.arange(n_warps, dtype=I32, device=dev), 11,
                        997) < torch.div(997 * n_tok, n_warps,
                                         rounding_mode="floor")
    gap = torch.tensor(float(gap), dtype=ft, device=dev)

    def full(shape, v, dtype=I32):
        return torch.full(shape, v, dtype=dtype, device=dev)
    sets, ways = prm["sets"], prm["ways"]
    st = {"tags": full((sets + 1, ways), -1),
          "rrip": full((sets + 1, ways), prm["rrip_max"]),
          "meta_type": full((sets + 1, ways), BALANCED),
          "eaf": full((prm["eaf_bits"] + 1,), 0), "eaf_gen": full((), 1),
          "eaf_ctr": full((), 0),
          **{k: full((prm["pc_entries"],), 0)
             for k in ("pc_hits", "pc_acc", "pc_req")}}
    c = prm["dram_channels"]
    q = {"bank_free": full((prm["banks"],), 0.0, ft),
         "bank_ts": full((prm["banks"],), _NEG, ft),
         "cur_row": full((c,), -1),
         **{k: full((c,), 0.0, ft) for k in ("hp_free", "lp_free")},
         **{k: full((c,), _NEG, ft) for k in ("hp_ts", "hp_sa", "lp_ts",
                                              "lp_sa")}}
    w1 = n_warps + 1
    clf = Clf(full((w1,), 0), full((w1,), 0), full((w1,), BALANCED),
              full((w1,), 0.5, torch.float32), full((w1,), 0),
              full((w1,), 0))
    ready, ptr = full((w1,), 0.0, ft), full((w1,), 0)
    m = {"qdelay_hist": full((len(_QEDGES) + 1,), 0),
         "qdelay_sum": full((), 0.0, ft), "stall_cycles": full((), 0.0, ft),
         "evictions_by_type": full((NUM_TYPES,), 0),
         **{k: full((), 0) for k in ("l2_accesses", "l2_hits",
                                     "dram_accesses", "row_hits",
                                     "bypasses")}}
    edges = torch.tensor(_QEDGES, dtype=ft, device=dev)
    b = max(1, min(wave_size, n_warps))
    cap = -(-n_instr * n_warps // b) + n_instr
    k = 0
    while k < cap and bool((ptr[:n_warps] < n_instr).any()):
        loc = torch.sort(torch.where(ptr[:n_warps] < n_instr,
                                     ready[:n_warps], float("inf")),
                         stable=True).indices[:b]
        ptr_b = ptr[loc]
        slot_ok = ptr_b < n_instr
        i_g = ptr_b.long().clamp(max=n_instr - 1)
        t0 = ready[loc]
        clf_b, recs = cache_pass(
            st, Clf(*(f[loc] for f in clf)), tokens[loc], t0,
            lines_wi[loc, i_g].transpose(0, 1).contiguous(),
            pcs_wi[loc, i_g], orc_wi[loc, i_g], slot_ok, prm, pa, ft)
        t_done, qdelay, use_s, go_dram, row_hit = timing_pass(q, recs, prm,
                                                              ft)
        valid_lb, byp_lb, use_lb, hit_lb = recs[2], recs[3], recs[4], recs[5]
        bins = (qdelay[..., None] >= edges).sum(-1)
        m["qdelay_hist"].index_add_(0, bins, use_s.to(I32))
        m["qdelay_sum"] = m["qdelay_sum"] + torch.sum(qdelay)
        m["dram_accesses"] = m["dram_accesses"] + go_dram.sum(dtype=I32)
        m["row_hits"] = m["row_hits"] + row_hit.sum(dtype=I32)
        m["l2_accesses"] = m["l2_accesses"] + use_lb.sum(dtype=I32)
        m["l2_hits"] = m["l2_hits"] + hit_lb.sum(dtype=I32)
        m["bypasses"] = m["bypasses"] + byp_lb.sum(dtype=I32)
        m["evictions_by_type"].index_add_(0, recs[7].reshape(-1).long(),
                                          recs[8].reshape(-1).to(I32))
        dmax = torch.where(valid_lb, t_done, _NEG).amax(dim=0)
        dmin = torch.where(valid_lb, t_done, float("inf")).amin(dim=0)
        has_req = torch.isfinite(dmax)
        m["stall_cycles"] = m["stall_cycles"] + torch.sum(
            torch.where(has_req & slot_ok, dmax - dmin, 0.0))
        ok = torch.where(slot_ok, loc, n_warps)
        for f_all, f_b in zip(clf, clf_b):
            f_all[loc] = f_b
        ready[ok] = torch.where(has_req, dmax + gap, t0 + gap)
        ptr[ok] = ptr_b + 1
        k += 1
    r = ready[:n_warps]
    per_warp = torch.clamp_min(r - gap, 1.0)
    out = {k: v.float().cpu().numpy() if v.is_floating_point()
           else v.cpu().numpy() for k, v in m.items()}
    out.update(ipc=float(torch.sum(n_instr / per_warp.float())),
               makespan=float(r.max()), qdelay_sum=float(m["qdelay_sum"]),
               stall_cycles=float(m["stall_cycles"]))
    return out
