"""Wavefront engine (``engine="wavefront"``): batched round-lockstep
event loop, in torch.

Each step pops a *wave* of the ``wave_size`` earliest-ready warps and
services all their B×L requests vectorized, in two passes:

  1. **Cache pass** (``repro_torch.kernels.cache_pass``, gate
     ``cache_backend``): bypass decisions, tag lookup, RRIP
     fill/eviction, EAF and PC-table bookkeeping, and the classifier
     update on wave-resident [B] counter rows. None of it depends on
     request timing.
  2. **Timing pass** (``repro_torch.kernels.wavefront_scan``, gate
     ``scan_backend``): all B×L requests in warp-major chronological
     order go through segmented prefix queue recovery per L2 bank, DRAM
     channel and priority class; the cross-wave carry uses the
     work-conserving backlog floor.

On CUDA tensors each pass is one launch of its Hopper kernel; on CPU
tensors the plain PyTorch versions run. The loop is a Python loop that
stops when no warp is active or at the ``n_waves`` cap — one host sync
per wave. The per-wave selection is a stable sort of the ready times
(ties by warp id, the event loop's argmin), never ``torch.topk``, whose
tie order is undefined; scatters that the reference drops out of bounds
are explicit masks. A wave of one warp takes the exact floor (the event
loop). No mesh or sharding code is ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.core.engine import request as REQ
from repro_torch.core.engine.state import SimParams, SimState, init_state
from repro_torch.core.classifier import ClassifierState
from repro_torch.kernels.cache_pass import ops as CPASS
from repro_torch.kernels.wavefront_scan import ops as WSCAN
from repro_torch.kernels.wavefront_scan.ref import QueueCarry
from repro_torch.policy import PolicyArrays, ops as POL

F32 = torch.float32
I32 = torch.int32

_NEG = float("-inf")


@dataclasses.dataclass
class WaveCounter:
    """Waves run by ``simulate_core`` in this process; ``chip_smoke.py``
    holds each kernel's launch count against it (one launch per wave)."""
    waves: int = 0


WAVES = WaveCounter()


def default_wave_size(n_warps: int) -> int:
    """Readiness-window size: W/6 (at least min(W, 8)) up to 256 warps,
    W/4 above (the reference's calibration, DESIGN.md §9)."""
    if n_warps > 256:
        return n_warps // 4
    return max(min(n_warps, 8), n_warps // 6)


class QueueAnchors(NamedTuple):
    """Per-queue service frontier in two time axes: ``*_ts`` the largest
    L2-arrival (wave sort) time serviced, ``*_sa`` the largest
    service-arrival time. With the busy-until horizons of ``SimState``
    they summarize each queue's backlog for the next wave."""
    bank_ts: torch.Tensor     # f32[banks]
    hp_ts: torch.Tensor       # f32[channels]
    hp_sa: torch.Tensor       # f32[channels]
    lp_ts: torch.Tensor       # f32[channels]
    lp_sa: torch.Tensor       # f32[channels]


def init_anchors(prm: SimParams, device) -> QueueAnchors:
    def neg(n):
        return torch.full((n,), _NEG, dtype=F32, device=device)
    c = prm.dram_channels
    return QueueAnchors(bank_ts=neg(prm.banks), hp_ts=neg(c), hp_sa=neg(c),
                        lp_ts=neg(c), lp_sa=neg(c))


def _timing_pass(st: SimState, an: QueueAnchors, recs, prm: SimParams,
                 backend: str) -> tuple:
    """Arrival-ordered queue recovery for one wave's B×L requests, in
    warp-major order (a warp's lanes stay consecutive — the event loop's
    processing order). Returns ``(st, anchors, t_done[L, B])``."""
    t_s, addr_s, valid_s, byp_s, use_l2_s, hit_s, hp_s = \
        [x.transpose(0, 1).reshape(-1) for x in recs[:7]]  # [N = B*L]
    # a wave of ONE warp is the event loop: the plain busy-until floor
    exact = recs[0].shape[1] == 1

    bank = REQ.bank_index(addr_s, prm)
    ch = REQ.dram_channel(addr_s, prm)
    row = REQ.dram_row(addr_s, prm)
    go_dram = valid_s & (byp_s | ~hit_s)

    carry = QueueCarry(
        bank_free=st.bank_free, bank_ts=an.bank_ts,
        hp_free=st.hp_free, hp_ts=an.hp_ts, hp_sa=an.hp_sa,
        lp_free=st.lp_free, lp_ts=an.lp_ts, lp_sa=an.lp_sa,
        cur_row=st.cur_row)
    t_head, t0, row_hit, nc = WSCAN.wave_queue_recovery(
        t_s, bank, use_l2_s, ch, row, go_dram, byp_s, hp_s, carry,
        banks=prm.banks, channels=prm.dram_channels, l2_svc=prm.l2_svc,
        l2_lat=prm.l2_lat, occ_rowhit=prm.occ_rowhit,
        occ_rowmiss=prm.occ_rowmiss, exact=exact, backend=backend)

    qdelay = torch.where(use_l2_s, t_head - t_s, 0.0)
    _, lat = REQ.dram_occ_lat(row_hit, prm)
    t_done = torch.where(hit_s, t_head + prm.l2_lat, t0 + lat)
    t_done = torch.where(valid_s, t_done, t_s)

    # ---- metrics (integer adds are exact in any order) ---------------------
    m = st.metrics
    metrics = dict(m)
    metrics["qdelay_hist"] = m["qdelay_hist"] + _hist(
        REQ.qdelay_bin(qdelay), use_l2_s, m["qdelay_hist"].shape[0])
    metrics["qdelay_sum"] = m["qdelay_sum"] + torch.sum(qdelay)
    metrics["dram_accesses"] = m["dram_accesses"] + go_dram.sum(dtype=I32)
    metrics["row_hits"] = m["row_hits"] + row_hit.sum(dtype=I32)

    new_st = st._replace(bank_free=nc.bank_free, cur_row=nc.cur_row,
                         hp_free=nc.hp_free, lp_free=nc.lp_free,
                         metrics=metrics)
    new_an = QueueAnchors(bank_ts=nc.bank_ts, hp_ts=nc.hp_ts,
                          hp_sa=nc.hp_sa, lp_ts=nc.lp_ts, lp_sa=nc.lp_sa)
    # back to the cache pass's [L, B] layout
    lanes, b = recs[0].shape
    return new_st, new_an, t_done.reshape(b, lanes).transpose(0, 1)


def _hist(idx, mask, n):
    """Integer histogram of ``idx`` over the masked entries (i32[n]); no
    host sync."""
    return torch.zeros((n,), dtype=I32, device=idx.device).index_add_(
        0, idx.long(), mask.to(I32))


def _masked_set_(full, idx, vals, mask):
    """In place: the reference's ``full.at[where(mask, idx, OOB)].set(
    vals, mode="drop")`` as an explicit mask, for distinct ``idx``."""
    full[idx] = torch.where(mask, vals, full[idx])


def simulate_core(trace_lines, trace_pcs, compute_gap, oracle_types,
                  pa: PolicyArrays, *, n_warps: int, lanes: int,
                  prm: SimParams, wave_size: Optional[int] = None,
                  scan_backend: str = "auto",
                  cache_backend: str = "auto") -> Dict[str, Any]:
    """One workload × one policy on the wavefront engine.

    trace_lines: i32[I, W, L]; trace_pcs, oracle_types: i32[I, W];
    compute_gap: f32 0-d or f32[I]; ``pa`` one policy row. Every tensor
    on one device, which the whole run stays on."""
    dev = trace_lines.device
    n_instr = trace_lines.shape[0]
    B = max(1, min(wave_size or default_wave_size(n_warps), n_warps))
    # wave-count cap: with >= B warps active every wave services B
    # instructions; once fewer remain every wave advances all of them
    n_waves = -(-n_instr * n_warps // B) + n_instr
    tokens = POL.pcal_tokens(pa, n_warps)

    lines_wi = trace_lines.transpose(0, 1)          # [W, I, L]
    pcs_wi = trace_pcs.transpose(0, 1)              # [W, I]
    oracle_wi = oracle_types.transpose(0, 1)        # [W, I]

    st = init_state(n_warps, prm, dev)
    an = init_anchors(prm, dev)
    ready = torch.zeros((n_warps,), dtype=F32, device=dev)
    ptr = torch.zeros((n_warps,), dtype=I32, device=dev)
    ratio_t = torch.zeros((n_instr, n_warps), dtype=F32, device=dev)

    k = 0
    while k < n_waves and bool((ptr < n_instr).any()):
        active = ptr < n_instr
        # wave = the B earliest-ready active warps, slots in chronological
        # order, ties by warp id: a stable ascending sort, never topk
        order = torch.sort(torch.where(active, ready, float("inf")),
                           stable=True).indices
        w_sel = order[:B]
        slot_ok = active[w_sel]
        i_sel = ptr[w_sel].long()
        i_g = i_sel.clamp(max=n_instr - 1)          # JAX clamps the gather
        t0 = ready[w_sel]
        lines_b = lines_wi[w_sel, i_g]              # [B, L]
        pc_b = pcs_wi[w_sel, i_g]
        owt_b = oracle_wi[w_sel, i_g]

        # wave-resident classifier rows: gather once, scatter back once
        # (wave warp ids are distinct)
        clf_b0 = ClassifierState(*(a[w_sel] for a in st.clf))
        st, clf_b, recs = CPASS.wave_cache_pass(
            st, clf_b0, tokens[w_sel], t0, lines_b.transpose(0, 1)
            .contiguous(), pc_b, owt_b, slot_ok, prm, pa,
            backend=cache_backend)
        for full, b in zip(st.clf, clf_b):
            full[w_sel] = b
        st, an, t_done = _timing_pass(st, an, recs, prm, scan_backend)

        (_, _, valid_lb, byp_lb, use_lb, hit_lb, _, vt_lb, ev_lb) = recs
        # write-only bookkeeping, once per wave (integer adds)
        metrics = dict(st.metrics)
        metrics["l2_accesses"] = metrics["l2_accesses"] + use_lb.sum(
            dtype=I32)
        metrics["l2_hits"] = metrics["l2_hits"] + hit_lb.sum(dtype=I32)
        metrics["bypasses"] = metrics["bypasses"] + byp_lb.sum(dtype=I32)
        n_types = metrics["evictions_by_type"].shape[0]
        metrics["evictions_by_type"] = metrics["evictions_by_type"] + \
            _hist(vt_lb.reshape(-1), ev_lb.reshape(-1), n_types)
        st = st._replace(
            tot_hits=st.tot_hits.index_add(0, w_sel,
                                           hit_lb.sum(0, dtype=I32)),
            tot_acc=st.tot_acc.index_add(0, w_sel,
                                         valid_lb.sum(0, dtype=I32)),
            metrics=metrics)

        dmax = torch.where(valid_lb, t_done, _NEG).amax(dim=0)
        dmin = torch.where(valid_lb, t_done, float("inf")).amin(dim=0)
        has_req = torch.isfinite(dmax)
        stall = torch.where(has_req & slot_ok, dmax - dmin, 0.0)
        metrics["stall_cycles"] = metrics["stall_cycles"] + torch.sum(stall)

        # the loop owns ready/ptr/ratio_t: masked writes go in place
        gap = compute_gap if compute_gap.ndim == 0 else compute_gap[i_g]
        _masked_set_(ready, w_sel,
                     torch.where(has_req, dmax + gap, t0 + gap), slot_ok)
        _masked_set_(ptr, w_sel, ptr[w_sel] + 1, slot_ok)
        # Fig 4 snapshot: sampled ratio after each serviced instruction
        _masked_set_(ratio_t, (i_g, w_sel), st.clf.ratio[w_sel], slot_ok)
        k += 1
        WAVES.waves += 1

    return REQ.finalize_outputs(st, ready, ratio_t, compute_gap,
                                n_instr=n_instr, n_warps=n_warps, prm=prm)
