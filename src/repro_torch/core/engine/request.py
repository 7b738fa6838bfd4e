"""Per-request math of the event and wavefront engines, in torch.

The index helpers, the bypass decision on gathered inputs, the insertion
rank, the DRAM row-buffer timing split, the queue-delay binning and the
end-of-run aggregation — each a torch form of ``repro.core.engine.request``
with the reference's int32/float32 types pinned.

``addr // row_lines`` is floor division (-1 // 32 == -1), as in the
reference; the CUDA kernels derive rows and channels the same way.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.engine.state import _QBINS, SimParams, SimState
from repro_torch.policy import PolicyArrays, ops as POL

F32 = torch.float32
I32 = torch.int32

hash_index = POL.hash_index


# ---------------------------------------------------------------------------
# structure indexing (set / bank / channel / PC-table / EAF)
# ---------------------------------------------------------------------------

def bank_index(addr, prm: SimParams):
    return hash_index(addr, 1, prm.banks)


def set_index(addr, prm: SimParams):
    return hash_index(addr, 2, prm.sets)


def pc_index(pc, prm: SimParams):
    return hash_index(pc, 3, prm.pc_entries)


def dram_row(addr, prm: SimParams):
    return torch.div(addr, prm.row_lines, rounding_mode="floor").to(I32)


def dram_channel(addr, prm: SimParams):
    return hash_index(dram_row(addr, prm), 4, prm.dram_channels)


def eaf_index(addr, prm: SimParams):
    return hash_index(addr, 5, prm.eaf_bits)


# ---------------------------------------------------------------------------
# ② bypass decision from current classifier / PC-table state
# ---------------------------------------------------------------------------

def bypass_decision_core(warp_type_w, accesses_w, token_w, pc_hits_v,
                         pc_acc_v, pc_req_v, addr, valid, prm: SimParams,
                         pa: PolicyArrays, oracle_wt, rand_u=None):
    """The bypass decision on fully-gathered inputs: per-warp classifier
    values and the request's PC-table counter values. Returns
    ``(byp & valid, wtype)``."""
    wtype = POL.select_label(pa, warp_type_w, oracle_wt)
    # periodic re-learning probe: the Nth access of each probe window
    # (``% pi == pi - 1``, not ``== 0``) is forced down the cache path
    pi = POL.probe_interval(pa, prm.probe_interval).to(I32)
    probe = (accesses_w % pi) == pi - 1
    if rand_u is None:
        rand_u = hash_index(addr, 7, 65536).to(F32) / 65536.0
    byp = POL.bypass_decision(pa, wtype=wtype, probe=probe,
                              token_bit=token_w, pc_hits=pc_hits_v,
                              pc_acc=pc_acc_v, pc_req=pc_req_v,
                              rand_u=rand_u)
    return byp & valid, wtype


def bypass_decision_vals(warp_type_w, accesses_w, token_w, st: SimState,
                         addr, pc, valid, prm: SimParams,
                         pa: PolicyArrays, oracle_wt):
    """``bypass_decision_core`` with the PC-table counters gathered from
    ``st``. Returns ``(byp, wtype, pidx)``."""
    pidx = pc_index(pc, prm)
    byp, wtype = bypass_decision_core(
        warp_type_w, accesses_w, token_w, st.pc_hits[pidx],
        st.pc_acc[pidx], st.pc_req[pidx], addr, valid, prm, pa, oracle_wt)
    return byp, wtype, pidx


def bypass_decision(st: SimState, w, addr, pc, valid, prm: SimParams,
                    pa: PolicyArrays, tokens, oracle_wt):
    """Returns ``(byp, wtype, pidx)`` for one request of each of N
    simulations: ``st`` and ``pa`` carry a leading [N] axis, ``w``,
    ``addr``, ``pc``, ``valid`` and ``oracle_wt`` are [N] and ``tokens``
    is [N, W]. The per-warp classifier inputs and the PC-table counters
    are gathered here, one row per simulation (the event engine's form
    of the reference's ``bypass_decision``)."""
    sim = torch.arange(w.shape[0], device=w.device)
    pidx = pc_index(pc, prm).long()
    byp, wtype = bypass_decision_core(
        st.clf.warp_type[sim, w], st.clf.accesses[sim, w], tokens[sim, w],
        st.pc_hits[sim, pidx], st.pc_acc[sim, pidx], st.pc_req[sim, pidx],
        addr, valid, prm, pa, oracle_wt)
    return byp, wtype, pidx


# ---------------------------------------------------------------------------
# ③ insertion rank (policy + evicted-address-filter signal)
# ---------------------------------------------------------------------------

def insertion_rank(st: SimState, wtype, addr, prm: SimParams,
                   pa: PolicyArrays):
    # a filter bit is set iff it carries the current generation stamp
    ebit = st.eaf[eaf_index(addr, prm)] == st.eaf_gen
    return POL.insertion_rank(pa, wtype=wtype, eaf_bit=ebit,
                              rrip_max=prm.rrip_max)


# ---------------------------------------------------------------------------
# ④ DRAM row-buffer timing split
# ---------------------------------------------------------------------------

def dram_occ_lat(row_hit, prm: SimParams):
    """Row-hit/row-miss split into occupancy (pipelined throughput) and
    latency (critical path) components, float32."""
    occ = torch.where(row_hit, prm.occ_rowhit, prm.occ_rowmiss)
    lat = torch.where(row_hit, prm.t_rowhit, prm.t_rowmiss)
    return occ, lat


# ---------------------------------------------------------------------------
# queuing-delay histogram binning (Fig 5)
# ---------------------------------------------------------------------------

def qdelay_bin(qdelay):
    """Map queue delays to their histogram bin, elementwise (i32)."""
    edges = _QBINS[1:-1].to(qdelay.device)
    return (qdelay[..., None] >= edges).sum(-1, dtype=I32)


# ---------------------------------------------------------------------------
# end-of-simulation outputs
# ---------------------------------------------------------------------------

def finalize_outputs(st: SimState, ready, ratio_t, compute_gap, *,
                     n_instr: int, n_warps: int,
                     prm: SimParams) -> Dict[str, Any]:
    """Aggregate the final state into the public metrics dict.

    The float reductions (``ipc``, ``energy``, …) sum in torch's order,
    not XLA's; every per-element output is bitwise the reference's."""
    makespan = torch.max(ready)
    m = dict(st.metrics)
    total_instr = torch.tensor(float(n_instr * n_warps), dtype=F32,
                               device=ready.device)
    # steady-state throughput: the sum of per-warp progress rates; each
    # warp's ready time includes one trailing gap — the last instruction's
    last_gap = compute_gap if compute_gap.ndim == 0 else compute_gap[-1]
    per_warp_time = torch.clamp_min(ready - last_gap, 1.0)
    ipc = torch.sum(n_instr / per_warp_time)
    ipc_makespan = total_instr / torch.clamp_min(makespan, 1.0)
    energy = (m["l2_accesses"] * prm.e_l2 + m["dram_accesses"] * prm.e_dram
              + makespan * prm.e_static)
    out = dict(m)
    out.update({
        "makespan": makespan,
        "ipc": ipc,
        "ipc_makespan": ipc_makespan,
        "warp_time": per_warp_time,
        "energy": energy,
        "perf_per_energy": ipc / energy * 1e3,
        "warp_hit_ratio": st.tot_hits / torch.clamp_min(st.tot_acc, 1),
        "warp_type": st.clf.warp_type,
        "ratio_over_time": ratio_t,            # [I, W]
        "miss_rate": 1.0 - m["l2_hits"] / torch.clamp_min(
            m["l2_accesses"], 1),
        "mean_qdelay": m["qdelay_sum"] / torch.clamp_min(
            m["l2_accesses"], 1),
    })
    return out
