"""Plain PyTorch wavefront queue recovery: the timing pass of one wave.

A torch form of ``repro.kernels.wavefront_scan.ref`` (the reference's
unfused multi-pass oracle): one cumsum + ``cummax`` segmented prefix per
queue family over dense ``[Q, N]`` masks, a ``cummax`` predecessor chain
for the DRAM row buffer, and a second prefix pass for the low-priority
queue whose floor folds in the high-priority busy horizon. For one wave
of N arrival-ordered requests it recovers the FIFO service times the
event engine would produce request by request:
``start_j = c_j + max_{i<=j}(max(t_i, floor_i) - c_i)``, ``c`` the
exclusive prefix occupancy of the request's queue.

It is the CPU path of ``ops.wave_queue_recovery`` and the plain version
``chip_smoke.py`` holds the CUDA kernel against, bitwise: occupancies are
integer-valued, so every prefix sum is exact in any order, and the rest
is the same float operations on the same values.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

F32 = torch.float32
I32 = torch.int32
_NEG = float("-inf")


class QueueCarry(NamedTuple):
    """Cross-wave queue state: ``*_free`` are busy-until horizons,
    ``*_ts``/``*_sa`` the service-frontier anchors in wave-sort /
    service-arrival time, ``cur_row`` the open DRAM row per channel."""
    bank_free: torch.Tensor   # f32[banks]
    bank_ts: torch.Tensor     # f32[banks]
    hp_free: torch.Tensor     # f32[channels]
    hp_ts: torch.Tensor       # f32[channels]
    hp_sa: torch.Tensor       # f32[channels]
    lp_free: torch.Tensor     # f32[channels]
    lp_ts: torch.Tensor       # f32[channels]
    lp_sa: torch.Tensor       # f32[channels]
    cur_row: torch.Tensor     # i32[channels]


def carry_floor(free, last_ts, last_sa, t_s, t_svc):
    """Work-conserving carry floor [Q, N] for the next wave's requests.

    A request at/after the queue's serviced frontier (``t_s >= last_ts``)
    waits for the full busy-until; a retrograde one sees the queue's
    standing backlog (``free - last_sa``) anchored at its own
    service-arrival time. A never-used queue (-inf anchors) has a +inf
    backlog, so the floor is the plain busy-until."""
    backlog = (free - last_sa)[:, None]
    interp = torch.minimum(free[:, None], t_svc[None, :] + backlog)
    return torch.where(t_s[None, :] >= last_ts[:, None], free[:, None],
                       interp)


def anchor_update(last, mask, t):
    return torch.maximum(last,
                         torch.where(mask, t[None, :], _NEG).amax(dim=1))


def queue_prefix(mask, t_arr, occ, free):
    """FIFO service start times for one queue family, vectorized.

    mask: bool[Q, N] — request j belongs to queue q; t_arr: f32[N]
    arrivals; occ: f32[N] per-request occupancy; free: f32[Q, 1|N]
    per-slot busy-until floor. Returns (start[Q, N], end[Q, N]); ``end``
    is -inf outside ``mask``."""
    occ_m = torch.where(mask, occ[None, :], 0.0)
    c = torch.cumsum(occ_m, dim=1) - occ_m            # exclusive prefix occ
    v = torch.where(mask, torch.maximum(t_arr[None, :], free) - c, _NEG)
    start = c + torch.cummax(v, dim=1).values
    end = torch.where(mask, start + occ_m, _NEG)
    return start, end


def wave_queue_recovery_ref(t_s, bank, use_l2, ch, row, go_dram, byp, hp,
                            carry: QueueCarry, *, banks: int, channels: int,
                            l2_svc: float, l2_lat: float, occ_rowhit: float,
                            occ_rowmiss: float, exact: bool):
    """Recover one wave's bank/HP/LP service times, multi-pass.

    Slot arrays are [N] in warp-major chronological order; ``carry`` is
    the cross-wave queue state. ``exact=True`` (a wave of one warp — the
    event loop) uses the plain busy-until floor instead of the backlog
    interpolation. Returns ``(t_head, t0, row_hit, new_carry)``:
    per-slot L2-bank service start (0 outside ``use_l2``), DRAM service
    start (defined on ``go_dram`` slots; elsewhere the deterministic
    value the same formulas give), row-buffer hit flags, and the advanced
    carry.
    """
    n = t_s.shape[0]
    dev = t_s.device
    slot = torch.arange(n, dtype=I32, device=dev)

    def floor(free, last_ts, last_sa, t_svc):
        if exact:
            return free[:, None]
        return carry_floor(free, last_ts, last_sa, t_s, t_svc)

    # ---- L2 bank queues ----------------------------------------------------
    bmask = (bank[None, :] == torch.arange(banks, dtype=I32,
                                           device=dev)[:, None]) \
        & use_l2[None, :]
    svc = torch.full((n,), l2_svc, dtype=F32, device=dev)
    b_start, b_end = queue_prefix(
        bmask, t_s, svc,
        floor(carry.bank_free, carry.bank_ts, carry.bank_ts, t_s))
    t_head = torch.where(bmask, b_start, 0.0).sum(dim=0)
    bank_free = torch.maximum(carry.bank_free, b_end.amax(dim=1))

    # ---- DRAM two-queue FR-FCFS --------------------------------------------
    t_da = torch.where(byp, t_s, t_head + l2_lat)
    cmask = (ch[None, :] == torch.arange(channels, dtype=I32,
                                         device=dev)[:, None]) \
        & go_dram[None, :]

    # row-buffer chain: each request's predecessor is the previous
    # request in its channel within this wave, else the carried open row
    inc = torch.cummax(torch.where(cmask, slot[None, :], -1), dim=1).values
    prev_idx = torch.cat(
        [torch.full((channels, 1), -1, dtype=I32, device=dev),
         inc[:, :-1]], dim=1)
    prev_row = torch.where(prev_idx >= 0,
                           row[prev_idx.clamp_min(0).long()],
                           carry.cur_row[:, None])
    own = ch.long()[None, :]
    row_hit = (prev_row == row[None, :]).gather(0, own)[0] & go_dram
    occ = torch.where(row_hit, occ_rowhit, occ_rowmiss)

    mask_hp = cmask & hp[None, :]
    hp_carry = floor(carry.hp_free, carry.hp_ts, carry.hp_sa, t_da)
    hp_start, hp_end = queue_prefix(mask_hp, t_da, occ, hp_carry)
    # strict priority: a low-priority request waits for the high queue's
    # busy horizon at its chronological position
    hp_busy = torch.cat(
        [torch.full((channels, 1), _NEG, dtype=F32, device=dev),
         torch.cummax(hp_end, dim=1).values[:, :-1]], dim=1)
    lp_floor = torch.maximum(
        floor(carry.lp_free, carry.lp_ts, carry.lp_sa, t_da),
        torch.maximum(hp_carry, hp_busy))
    mask_lp = cmask & ~hp[None, :]
    lp_start, lp_end = queue_prefix(mask_lp, t_da, occ, lp_floor)

    t0 = torch.where(hp, hp_start.gather(0, own)[0],
                     lp_start.gather(0, own)[0])
    hp_free = torch.maximum(carry.hp_free, hp_end.amax(dim=1))
    lp_free = torch.maximum(carry.lp_free, lp_end.amax(dim=1))
    last_idx = inc[:, -1]
    cur_row = torch.where(last_idx >= 0, row[last_idx.clamp_min(0).long()],
                          carry.cur_row)

    new_carry = QueueCarry(
        bank_free=bank_free,
        bank_ts=anchor_update(carry.bank_ts, bmask, t_s),
        hp_free=hp_free,
        hp_ts=anchor_update(carry.hp_ts, mask_hp, t_s),
        hp_sa=anchor_update(carry.hp_sa, mask_hp, t_da),
        lp_free=lp_free,
        lp_ts=anchor_update(carry.lp_ts, mask_lp, t_s),
        lp_sa=anchor_update(carry.lp_sa, mask_lp, t_da),
        cur_row=cur_row)
    return t_head, t0, row_hit, new_carry
