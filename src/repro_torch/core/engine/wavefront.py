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
go to a sink row past the real ones. A wave of one warp takes the exact
floor (the event loop).

The warps and their per-warp state live in shards: one, on the passes'
device, or, on the sharded-warp path (``warp_mesh`` + ``warp_axes``, the
reference's sharded-warp engine), n contiguous blocks, each on its mesh
device. Each wave gathers its rows from their owners, runs both passes
once on the passes' device, and scatters back: every mesh gives bitwise
the one-shard run.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple,
                    Optional)

import torch

from repro_torch import sharding as SH
from repro_torch import spans as SP
from repro_torch.core import classifier as CLF
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


class Wave(NamedTuple):
    """One wave's inputs, gathered from its warps' rows: [B] slots in
    chronological order (``lines_b`` [B, L])."""
    slot_ok: torch.Tensor       # bool: the slot's warp was active
    i_g: torch.Tensor           # i64: its instruction (clamped)
    t0: torch.Tensor            # f32: its ready time
    lines_b: torch.Tensor
    pc_b: torch.Tensor
    owt_b: torch.Tensor
    clf_b: ClassifierState      # the warps' classifier rows
    tokens_b: torch.Tensor


class WaveOut(NamedTuple):
    """What a wave writes back to its warps' rows, [B] slots."""
    clf_b: ClassifierState
    hits_b: torch.Tensor        # i32: lifetime-counter increments
    acc_b: torch.Tensor
    ready_b: torch.Tensor       # f32: the next ready time (active slots)


def _service(st: SimState, an: QueueAnchors, wv: Wave, compute_gap,
             prm: SimParams, pa: PolicyArrays, scan_backend: str,
             cache_backend: str) -> tuple:
    """One wave's cache pass, timing pass and bookkeeping on the
    device of ``st``. Returns ``(st, anchors, WaveOut)``."""
    st, clf_b, recs = CPASS.wave_cache_pass(
        st, wv.clf_b, wv.tokens_b, wv.t0,
        wv.lines_b.transpose(0, 1).contiguous(), wv.pc_b, wv.owt_b,
        wv.slot_ok, prm, pa, backend=cache_backend)
    st, an, t_done = _timing_pass(st, an, recs, prm, scan_backend)

    (_, _, valid_lb, byp_lb, use_lb, hit_lb, _, vt_lb, ev_lb) = recs
    # write-only bookkeeping, once per wave (integer adds)
    metrics = dict(st.metrics)
    metrics["l2_accesses"] = metrics["l2_accesses"] + use_lb.sum(dtype=I32)
    metrics["l2_hits"] = metrics["l2_hits"] + hit_lb.sum(dtype=I32)
    metrics["bypasses"] = metrics["bypasses"] + byp_lb.sum(dtype=I32)
    n_types = metrics["evictions_by_type"].shape[0]
    metrics["evictions_by_type"] = metrics["evictions_by_type"] + \
        _hist(vt_lb.reshape(-1), ev_lb.reshape(-1), n_types)

    dmax = torch.where(valid_lb, t_done, _NEG).amax(dim=0)
    dmin = torch.where(valid_lb, t_done, float("inf")).amin(dim=0)
    has_req = torch.isfinite(dmax)
    stall = torch.where(has_req & wv.slot_ok, dmax - dmin, 0.0)
    metrics["stall_cycles"] = metrics["stall_cycles"] + torch.sum(stall)

    gap = compute_gap if compute_gap.ndim == 0 else compute_gap[wv.i_g]
    return st._replace(metrics=metrics), an, WaveOut(
        clf_b=clf_b, hits_b=hit_lb.sum(0, dtype=I32),
        acc_b=valid_lb.sum(0, dtype=I32),
        ready_b=torch.where(has_req, dmax + gap, wv.t0 + gap))


def _wave_cap(n_instr: int, n_warps: int, wave_size: Optional[int]):
    """``(B, n_waves)``: the wave size and the wave-count cap. With >= B
    warps active every wave services B instructions; once fewer remain
    every wave advances all of them."""
    B = max(1, min(wave_size or default_wave_size(n_warps), n_warps))
    return B, -(-n_instr * n_warps // B) + n_instr


class Shard(NamedTuple):
    """One contiguous block of ``wk`` warps on its device: its trace rows
    and tokens (read only), and its per-warp state. Each state row tensor
    carries one sink row past the block (index ``wk``): the slots of a
    wave that the shard does not own, or that are inactive, scatter
    there, so each real row takes at most one write a wave."""
    lines: torch.Tensor         # i32[wk, I, L]
    pcs: torch.Tensor           # i32[wk, I]
    oracle: torch.Tensor        # i32[wk, I]
    tokens: torch.Tensor        # bool[wk]
    ready: torch.Tensor         # f32[wk + 1]
    ptr: torch.Tensor           # i32[wk + 1]
    clf: ClassifierState        # [wk + 1] each
    tot_hits: torch.Tensor      # i32[wk + 1]
    tot_acc: torch.Tensor       # i32[wk + 1]
    ratio_t: torch.Tensor       # f32[I, wk + 1]


def make_shards(lines_wi, pcs_wi, oracle_wi, tokens,
                place: Callable) -> List[Shard]:
    """The warp-major trace rows and tokens cut into contiguous blocks by
    ``place`` (a tensor -> its blocks, each on its device, e.g.
    ``sharding.split_leading``), each block with fresh per-warp state on
    its device."""
    n_instr = lines_wi.shape[1]
    out = []
    for lines, pcs, oracle, tok in zip(*(place(x) for x in (
            lines_wi, pcs_wi, oracle_wi, tokens))):
        d, wk = lines.device, lines.shape[0]
        out.append(Shard(
            lines=lines, pcs=pcs, oracle=oracle, tokens=tok,
            ready=torch.zeros((wk + 1,), dtype=F32, device=d),
            ptr=torch.zeros((wk + 1,), dtype=I32, device=d),
            clf=CLF.init(wk + 1, d),
            tot_hits=torch.zeros((wk + 1,), dtype=I32, device=d),
            tot_acc=torch.zeros((wk + 1,), dtype=I32, device=d),
            ratio_t=torch.zeros((n_instr, wk + 1), dtype=F32, device=d)))
    return out


def select_wave(shards: List[Shard], n_instr: int, B: int,
                dev: torch.device) -> torch.Tensor:
    """The global warp ids of the wave, on ``dev``: the first ``B`` of
    the stable ascending sort of ``where(active, ready, inf)`` over all
    warps, ties by warp id (the event loop's argmin), never
    ``torch.topk``, whose tie order is undefined. One shard's sort is
    that sort. Otherwise each shard offers its first ``min(B, wk)`` by
    its own stable sort and ``dev`` stable-sorts their concatenation in
    shard order: among equal keys that order is shard order, then local
    order, i.e. ascending global id."""
    wk = shards[0].tokens.shape[0]
    sorts = [torch.sort(torch.where(sh.ptr[:wk] < n_instr, sh.ready[:wk],
                                    float("inf")), stable=True)
             for sh in shards]
    if len(sorts) == 1:
        return sorts[0].indices[:B]
    c = min(B, wk)
    keys = torch.cat([s.values[:c].to(dev) for s in sorts])
    ids = torch.cat([(s.indices[:c] + j * wk).to(dev)
                     for j, s in enumerate(sorts)])
    return ids[torch.sort(keys, stable=True).indices[:B]]


def _pick(mine: List[torch.Tensor], vals: List[torch.Tensor]):
    """Each slot's value from its owner: ``vals[j]`` (gathered by every
    shard at the slots' local ids, on the wave's device) where
    ``mine[j]``; one shard's values as they are."""
    out = vals[0]
    for m, v in zip(mine[1:], vals[1:]):
        out = torch.where(m.view(-1, *([1] * (v.ndim - 1))), v, out)
    return out


def simulate_core(trace_lines, trace_pcs, compute_gap, oracle_types,
                  pa: PolicyArrays, *, n_warps: int, lanes: int,
                  prm: SimParams, wave_size: Optional[int] = None,
                  scan_backend: str = "auto",
                  cache_backend: str = "auto",
                  warp_mesh: Optional[SH.Mesh] = None,
                  warp_axes: SH.MeshAxes = None,
                  home: Optional[Mapping[str, int]] = None
                  ) -> Dict[str, Any]:
    """One workload × one policy on the wavefront engine.

    trace_lines: i32[I, W, L]; trace_pcs, oracle_types: i32[I, W];
    compute_gap: f32 0-d or f32[I]; ``pa`` one policy row. The passes
    run, and the outputs end, on the device of ``pa`` and
    ``compute_gap``. The trace may lie elsewhere (the host): its
    warp-major rows go to their shard's device block by block.

    The warps live in shards (``make_shards``): one on the passes'
    device, or, with ``warp_mesh`` + ``warp_axes`` (resolved: their
    product divides ``n_warps``), the contiguous blocks of the
    sharded-warp path at the mesh coordinates ``home`` (the simulation's
    block on the other axes) with the warp axes' coordinates in turn, so
    the full trace never sits on one device.

    Each wave: ``select_wave``; every shard gathers the wave's slots at
    their local ids and the owners' values are kept (``_pick``); the
    cache and timing passes run once, on the passes' device, whatever
    the shard count; the results scatter back to the owners (other slots
    to each shard's sink row). The exit test combines the shards' flags
    on the passes' device: one host sync a wave. After the loop the
    per-warp state is concatenated in warp order, so
    ``finalize_outputs`` sums over warps in the unsharded order: every
    mesh gives bitwise the one-shard run."""
    dev = pa.pcal_frac.device
    n_instr = trace_lines.shape[0]
    B, n_waves = _wave_cap(n_instr, n_warps, wave_size)
    if warp_mesh is None or warp_axes is None:
        def place(x):
            return [x.to(dev)]
    else:
        def place(x):
            return SH.split_leading(x, warp_mesh, warp_axes, at=home)
    shards = make_shards(trace_lines.transpose(0, 1),
                         trace_pcs.transpose(0, 1),
                         oracle_types.transpose(0, 1),
                         POL.pcal_tokens(pa, n_warps), place)
    n, wk = len(shards), shards[0].tokens.shape[0]
    devices = [sh.tokens.device for sh in shards]
    st = init_state(0, prm, dev)   # per-warp rows live in the shards
    an = init_anchors(prm, dev)

    def pending() -> bool:
        flags = [(sh.ptr[:wk] < n_instr).any() for sh in shards]
        if n > 1:
            flags = [torch.stack([f.to(dev) for f in flags]).any()]
        return bool(flags[0])

    k = 0
    more = k < n_waves and pending()
    while more:
        with SP.span("wave.step", k):
            w_sel = select_wave(shards, n_instr, B, dev)
            if n == 1:
                loc, mine, locs = w_sel, [], [w_sel]
            else:
                own = torch.div(w_sel, wk, rounding_mode="floor")
                loc = w_sel - own * wk
                mine = [own == j for j in range(n)]
                locs = [loc.to(d) for d in devices]
            ptr_b = _pick(mine, [sh.ptr[lj].to(dev)
                                 for sh, lj in zip(shards, locs)])
            slot_ok = ptr_b < n_instr
            i_g = ptr_b.long().clamp(max=n_instr - 1)   # JAX clamps
            i_gs = [i_g.to(d) for d in devices]

            def gather(get):
                return _pick(mine, [get(sh, lj, ij).to(dev) for sh, lj, ij
                                    in zip(shards, locs, i_gs)])
            wv = Wave(
                slot_ok=slot_ok, i_g=i_g,
                t0=gather(lambda sh, lj, ij: sh.ready[lj]),
                lines_b=gather(lambda sh, lj, ij: sh.lines[lj, ij]),
                pc_b=gather(lambda sh, lj, ij: sh.pcs[lj, ij]),
                owt_b=gather(lambda sh, lj, ij: sh.oracle[lj, ij]),
                # wave-resident classifier rows: gathered once, scattered
                # back once (wave warp ids are distinct)
                clf_b=ClassifierState(*(
                    gather(lambda sh, lj, ij, f=f: sh.clf[f][lj])
                    for f in range(len(ClassifierState._fields)))),
                tokens_b=gather(lambda sh, lj, ij: sh.tokens[lj]))
            st, an, out = _service(st, an, wv, compute_gap, prm, pa,
                                   scan_backend, cache_backend)
            for j, (sh, d) in enumerate(zip(shards, devices)):
                dst = loc if n == 1 else torch.where(mine[j], loc, wk).to(d)
                ok = torch.where(slot_ok if n == 1 else mine[j] & slot_ok,
                                 loc, wk).to(d)
                for full, b in zip(sh.clf, out.clf_b):
                    full[dst] = b.to(d)
                sh.tot_hits.index_add_(0, dst, out.hits_b.to(d))
                sh.tot_acc.index_add_(0, dst, out.acc_b.to(d))
                sh.ready[ok] = out.ready_b.to(d)
                sh.ptr[ok] = (ptr_b + 1).to(d)
                # Fig 4 snapshot: sampled ratio after each serviced instruction
                sh.ratio_t[i_gs[j], ok] = out.clf_b.ratio.to(d)
            k += 1
            WAVES.waves += 1
            # the next wave's exit test, which waits for this one
            with SP.span("wave.pending", k):
                more = k < n_waves and pending()

    def cat(rows, dim=0):
        return torch.cat([r.to(dev) for r in rows], dim=dim)
    st = st._replace(
        clf=ClassifierState(*(cat([sh.clf[f][:wk] for sh in shards])
                              for f in range(len(ClassifierState._fields)))),
        tot_hits=cat([sh.tot_hits[:wk] for sh in shards]),
        tot_acc=cat([sh.tot_acc[:wk] for sh in shards]))
    return REQ.finalize_outputs(
        st, cat([sh.ready[:wk] for sh in shards]),
        cat([sh.ratio_t[:, :wk] for sh in shards], dim=1), compute_gap,
        n_instr=n_instr, n_warps=n_warps, prm=prm)
