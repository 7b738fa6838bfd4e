"""Simulation state and static configuration, in torch.

``SimParams`` is the hardware description (a frozen dataclass),
``SimState`` the machine state threaded through the wave loop (a
NamedTuple of int32/float32 tensors plus the metrics dict), and
``init_state`` the common initial condition. ``state_from_numpy`` builds
a ``SimState`` from the reference's fields, so tests can feed the same
warmed state to both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.core import classifier as CLF
from repro_torch.core import warp_types as WT

F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class SimParams:
    sets: int = 512
    ways: int = 8
    banks: int = 6
    l2_svc: float = 4.0        # bank occupancy per request (cycles)
    l2_lat: float = 20.0       # tag+data latency after reaching bank head
    dram_channels: int = 8
    row_lines: int = 32        # lines per DRAM row
    # occupancy (pipelined throughput) vs latency (critical path) split
    occ_rowhit: float = 5.0
    occ_rowmiss: float = 10.0
    t_rowhit: float = 100.0
    t_rowmiss: float = 200.0
    lane_skew: float = 0.5     # per-lane issue skew within an instruction
    rrip_max: int = 7
    eaf_bits: int = 4096
    eaf_capacity: int = 1024   # filter reset period (insertions)
    pc_entries: int = 256
    sampling_interval: int = 64
    # classifier probe cadence: every Nth access of a bypassing warp is
    # forced down the cache path (the default when the policy's
    # ``PolicyArrays.probe_interval`` is 0)
    probe_interval: int = 8
    mostly_hit_threshold: float = 0.8
    mostly_miss_threshold: float = 0.2
    # energy model (relative units, GPUWattch-flavoured)
    e_l2: float = 1.0
    e_dram: float = 12.0
    e_static: float = 0.08     # per cycle of makespan


class SimState(NamedTuple):
    tags: torch.Tensor          # i32[sets, ways] line addr or -1
    rrip: torch.Tensor          # i32[sets, ways]
    meta_type: torch.Tensor     # i32[sets, ways] inserting warp's type
    bank_free: torch.Tensor     # f32[banks]
    cur_row: torch.Tensor       # i32[channels]
    hp_free: torch.Tensor       # f32[channels]
    lp_free: torch.Tensor       # f32[channels]
    clf: CLF.ClassifierState
    eaf: torch.Tensor           # i32[eaf_bits] generation-stamped bloom bits
    eaf_gen: torch.Tensor       # i32[] current generation: a bit is set iff
    #                             eaf[i] == eaf_gen (the periodic reset is
    #                             a generation bump, not an array clear)
    eaf_ctr: torch.Tensor       # i32[] insertions since reset
    pc_hits: torch.Tensor       # i32[pc_entries] cache-path hits
    pc_acc: torch.Tensor        # i32[pc_entries] cache-path accesses
    pc_req: torch.Tensor        # i32[pc_entries] ALL valid requests (the
    #                             PC-probe cadence clock)
    tot_hits: torch.Tensor      # i32[W] lifetime counters (never reset)
    tot_acc: torch.Tensor       # i32[W]
    metrics: Dict[str, torch.Tensor]


#: the cache and PC-table fields of ``SimState`` that a wave's cache pass
#: advances, in the order the cache-pass kernel packs them
CACHE_FIELDS = ("tags", "rrip", "meta_type", "eaf", "eaf_gen", "eaf_ctr",
                "pc_hits", "pc_acc", "pc_req")


_QBINS = torch.tensor([0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                       1 << 30], dtype=F32)
N_QBINS = len(_QBINS) - 1      # one bin per [edge_i, edge_{i+1}) interval


#: float32 metrics; every other metric is int32
_F32_METRICS = ("qdelay_sum", "stall_cycles")


def init_metrics(device) -> Dict[str, torch.Tensor]:
    def z(shape=(), dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {
        "qdelay_hist": z((N_QBINS,)),
        "qdelay_sum": z(dtype=F32),
        "l2_accesses": z(),
        "l2_hits": z(),
        "dram_accesses": z(),
        "row_hits": z(),
        "bypasses": z(),
        "stall_cycles": z(dtype=F32),
        "evictions_by_type": z((WT.NUM_TYPES,)),
    }


def init_state(n_warps: int, prm: SimParams, device="cpu") -> SimState:
    def full(shape, v, dtype=I32):
        return torch.full(shape, v, dtype=dtype, device=device)
    return SimState(
        tags=full((prm.sets, prm.ways), -1),
        rrip=full((prm.sets, prm.ways), prm.rrip_max),
        meta_type=full((prm.sets, prm.ways), WT.BALANCED),
        bank_free=full((prm.banks,), 0.0, F32),
        cur_row=full((prm.dram_channels,), -1),
        hp_free=full((prm.dram_channels,), 0.0, F32),
        lp_free=full((prm.dram_channels,), 0.0, F32),
        clf=CLF.init(n_warps, device),
        eaf=full((prm.eaf_bits,), 0),
        eaf_gen=full((), 1),
        eaf_ctr=full((), 0),
        pc_hits=full((prm.pc_entries,), 0),
        pc_acc=full((prm.pc_entries,), 0),
        pc_req=full((prm.pc_entries,), 0),
        tot_hits=full((n_warps,), 0),
        tot_acc=full((n_warps,), 0),
        metrics=init_metrics(device),
    )


_F32_FIELDS = ("bank_free", "hp_free", "lp_free")


def state_from_numpy(fields: Mapping, device) -> SimState:
    """A ``SimState`` from the reference's fields given as numpy arrays:
    ``{name: array}`` for every ``SimState`` field, where ``clf`` is a
    mapping of the ``ClassifierState`` fields and ``metrics`` the metrics
    dict. Every tensor is pinned to the reference's dtype on ``device``."""
    def t(x, dtype):
        x = x.clone() if torch.is_tensor(x) else torch.tensor(np.asarray(x))
        return x.to(device=device, dtype=dtype)

    clf = fields["clf"]
    return SimState(
        clf=CLF.ClassifierState(**{
            f: t(clf[f], F32 if f == "ratio" else I32)
            for f in CLF.ClassifierState._fields}),
        metrics={k: t(v, F32 if k in _F32_METRICS else I32)
                 for k, v in fields["metrics"].items()},
        **{f: t(fields[f], F32 if f in _F32_FIELDS else I32)
           for f in SimState._fields if f not in ("clf", "metrics")})
