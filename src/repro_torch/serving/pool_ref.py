"""Reference (dict-based) pool manager — kept as the behavioural oracle.

Host numpy, copied from ``repro.serving.pool_ref``; where the reference
calls the jnp classifier ladder and insertion rank on numpy scalars, this
copy calls the port's torch ones on 0-d tensors. This is the original
per-block Python-dict implementation of the MeDiC KV-block-pool control
plane. The production ``serving.pool.MedicPoolManager`` re-implements it
on fixed-capacity numpy arrays driven by the shared ``policy`` decision
tables; ``tests/test_torch_pool_ref.py`` replays recorded access traces
through both and asserts their ``snapshot()``s match exactly. Do not
"optimize" this file — its value is fidelity.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import warp_types as WT
from repro_torch.serving.pool import PoolConfig


class DictPoolManager:
    """Residency + policy control plane (dict-based reference)."""

    def __init__(self, cfg: PoolConfig, max_seqs: int, on_evict=None):
        self.cfg = cfg
        self.max_seqs = max_seqs
        self.on_evict = on_evict or (lambda key: None)
        # per-(seq-slot, block-index) residency; block key = (slot, idx);
        # shared prefixes get their own pseudo-slots at the end
        self.resident: Dict[Tuple[int, int], int] = {}   # key -> rrip rank
        self.owner_type: Dict[Tuple[int, int], int] = {}
        # classifier counters per slot (incl. pseudo-slots)
        self.hits = np.zeros(max_seqs, np.int64)
        self.accesses = np.zeros(max_seqs, np.int64)
        self.win_hits = np.zeros(max_seqs, np.int64)
        self.win_acc = np.zeros(max_seqs, np.int64)
        self.seq_type = np.full(max_seqs, WT.BALANCED, np.int64)
        self.ratio = np.full(max_seqs, 0.5, np.float64)
        # two-queue transfer engine
        self.hp_free = 0.0
        self.lp_free = 0.0
        # metrics
        self.fetches = 0
        self.qdelays: List[float] = []
        self.evictions_by_type = np.zeros(WT.NUM_TYPES, np.int64)
        self.bypassed_blocks = 0

    # -- classification (①) -------------------------------------------------

    def _observe(self, slot: int, hit: bool):
        self.hits[slot] += hit
        self.accesses[slot] += 1
        self.win_hits[slot] += hit
        self.win_acc[slot] += 1
        if self.win_acc[slot] >= self.cfg.sampling_interval:
            r = self.win_hits[slot] / max(self.win_acc[slot], 1)
            self.ratio[slot] = r
            self.seq_type[slot] = int(WT.classify(
                torch.tensor(np.float32(r)),
                torch.tensor(np.int32(self.win_acc[slot])),
                mostly_hit_threshold=self.cfg.mostly_hit_threshold,
                mostly_miss_threshold=self.cfg.mostly_miss_threshold,
                min_samples=1))
            self.win_hits[slot] = 0
            self.win_acc[slot] = 0

    def reset_slot(self, slot: int):
        """New sequence admitted into the slot: drop its blocks + counters."""
        for key in [k for k in self.resident if k[0] == slot]:
            del self.resident[key]
            self.owner_type.pop(key, None)
        self.hits[slot] = self.accesses[slot] = 0
        self.win_hits[slot] = self.win_acc[slot] = 0
        self.seq_type[slot] = WT.BALANCED
        self.ratio[slot] = 0.5

    # -- the per-step residency transaction ----------------------------------

    def access(self, slot: int, blocks: List[int], now: float,
               resident_key: Optional[Tuple[int, int]] = None
               ) -> Tuple[float, List[int]]:
        """A decode step for sequence `slot` needs `blocks`. Returns
        (ready_time, fetched_block_list). Updates residency per policy.
        `resident_key` overrides the residency key (shared-prefix blocks
        live under a pseudo-slot while counting toward `slot`'s ratio)."""
        cfg = self.cfg
        medic = cfg.policy == "medic"
        stype = int(self.seq_type[slot])
        ready = now
        fetched = []
        for blk in blocks:
            key = resident_key if resident_key is not None else (slot, blk)
            hit = key in self.resident
            self._observe(slot, hit)
            if hit:
                # promotion: hit blocks move to rank 0 (MRU analogue)
                self.resident[key] = 0
                continue
            # ---- miss -> fetch through the two-queue scheduler (④) -------
            self.fetches += 1
            fetched.append(blk)
            hp = medic and WT.is_priority_type(np.int32(stype))
            if hp:
                t0 = max(self.hp_free, now)
                self.hp_free = t0 + cfg.fetch_occupancy
            else:
                t0 = max(self.lp_free, self.hp_free, now)
                self.lp_free = t0 + cfg.fetch_occupancy
            self.qdelays.append(t0 - now)
            ready = max(ready, t0 + cfg.fetch_latency)
            # ---- insertion / bypass (②③) ---------------------------------
            bypass = medic and WT.is_bypass_type(np.int32(stype))
            if bypass:
                self.bypassed_blocks += 1
                continue  # streamed: not retained
            rank = (int(WT.insertion_rank(
                torch.tensor(np.int32(stype)), cfg.rrip_max - 1))
                if medic else 0)
            self._insert(key, rank, stype)
        return ready, fetched

    def _insert(self, key, rank: int, stype: int):
        cfg = self.cfg
        while len(self.resident) >= cfg.budget_blocks:
            victim = max(self.resident.items(), key=lambda kv: kv[1])[0]
            vt = self.owner_type.pop(victim, WT.BALANCED)
            self.evictions_by_type[vt] += 1
            del self.resident[victim]
            self.on_evict(victim)
        # age everyone mildly on insertion pressure (RRIP-flavoured)
        if len(self.resident) >= cfg.budget_blocks - 1:
            for k in self.resident:
                self.resident[k] = min(self.resident[k] + 1, cfg.rrip_max)
        self.resident[key] = rank
        self.owner_type[key] = stype

    def insert_prefill(self, key, stype: int):
        """Blocks produced on-device at prefill: no fetch cost, but they
        enter the pool under the insertion/bypass policy."""
        medic = self.cfg.policy == "medic"
        if medic and WT.is_bypass_type(np.int32(stype)):
            self.bypassed_blocks += 1
            self.on_evict(key)   # streamed immediately (not retained)
            return
        rank = (int(WT.insertion_rank(
            torch.tensor(np.int32(stype)), self.cfg.rrip_max - 1))
            if medic else 0)
        self._insert(key, rank, stype)

    def is_resident(self, key) -> bool:
        return key in self.resident

    # -- metrics --------------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        ratios = np.where(self.accesses > 0,
                          self.hits / np.maximum(self.accesses, 1), np.nan)
        return {
            "fetches": self.fetches,
            "bypassed_blocks": self.bypassed_blocks,
            "mean_qdelay": float(np.mean(self.qdelays)) if self.qdelays else 0.0,
            "p99_qdelay": float(np.percentile(self.qdelays, 99)) if self.qdelays else 0.0,
            "qdelays": np.asarray(self.qdelays),
            "seq_hit_ratio": ratios,
            "seq_type": self.seq_type.copy(),
            "resident_blocks": len(self.resident),
            "evictions_by_type": self.evictions_by_type.copy(),
        }
