"""MeDiC KV-block-pool manager (altitude B — the production mechanism).

Host numpy, copied from ``repro.serving.pool`` so that it is bit-exact
against it; the imports name the port's own ``warp_types`` and
``policy``, and the metrics add ``lookups`` (every block key looked up,
the denominator of the pool's hit share).

Maps the paper's four components onto the two-tier KV store of a
serving runtime (see DESIGN.md §2 table):

  ① sequence-type identification — per-sequence residency hit/access
    counters via ``core.classifier``'s taxonomy (the same code that
    classifies warps in the altitude-A simulator);
  ② bypass — blocks fetched for mostly/all-miss sequences are *streamed*:
    landed for the step, never retained, so they neither pollute the pool
    nor occupy fetch-queue slots for retained traffic;
  ③ insertion — retained blocks join a pool-wide RRIP order seeded by the
    owner sequence's type (mostly-hit near-MRU, balanced mid, miss-class
    near-LRU);
  ④ two-queue fetch scheduler — host->HBM block fetches from mostly/all-hit
    sequences go to a strict-priority high queue; FCFS within queues over a
    modelled transfer engine (latency + bandwidth occupancy), mirroring the
    paper's two-queue FR-FCFS memory controller.

The ②③④ decisions come from the shared branchless policy engine: a
``PoolConfig.policy`` preset is lowered to ``policy.DecisionTables``
(numpy lookups evaluated once through the same ops the simulator runs), so
both altitudes share one mechanism implementation.

State is held in fixed-capacity numpy arrays (one row per budgeted block:
owner key, RRIP rank, owner type, insertion sequence), so lookup,
insertion-pressure aging, and victim selection are vectorized — the
dict-based original survives as ``serving.pool_ref.DictPoolManager`` and a
parity test pins this implementation to it.

The manager tracks real block residency against a device-HBM budget; block
payloads live in the engine's cache arrays and are offloaded/restored
through a host store so the data path is real, while fetch *timing* is
modelled.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import warp_types as WT
from repro_torch.policy import DecisionTables, Policy, to_arrays

# (slot, blk) keys packed as one int64 code for vectorized lookup; block
# indices are bounded by max_len / block_tokens (tens), far below this
_BLK_STRIDE = 1 << 21


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    budget_blocks: int               # device-HBM KV budget (in blocks)
    block_tokens: int = 16
    rrip_max: int = 7
    sampling_interval: int = 32      # block-accesses per re-classification
    mostly_hit_threshold: float = 0.8
    mostly_miss_threshold: float = 0.2
    # transfer-engine model (per block)
    fetch_latency: float = 8.0       # fixed host->HBM latency (engine ticks)
    fetch_occupancy: float = 1.0     # transfer-engine occupancy per block
    policy: str = "medic"            # "medic" | "lru"


# PoolConfig.policy presets, expressed in the unified policy engine
POOL_POLICIES: Dict[str, Policy] = {
    "medic": Policy("pool-medic", bypass="medic", insertion="medic",
                    scheduler="medic"),
    "lru": Policy("pool-lru"),
}


class MedicPoolManager:
    """Residency + policy control plane. One instance per engine.

    Array-backed: residency is a fixed-capacity table of ``budget_blocks``
    rows; a free row has owner slot -1. Victim selection replicates the
    reference dict semantics (max rank, earliest-inserted tie-break) via
    an insertion-sequence column, and insertion-pressure aging is one
    vectorized clamp instead of a per-key loop.
    """

    def __init__(self, cfg: PoolConfig, max_seqs: int, on_evict=None,
                 policy: Optional[Policy] = None):
        self.cfg = cfg
        self.max_seqs = max_seqs
        self.on_evict = on_evict or (lambda key: None)
        if cfg.budget_blocks < 1:
            raise ValueError("budget_blocks must be >= 1")
        # a Policy object (the unified engine's preset) overrides the
        # cfg.policy string: this is how the serving simulator sweeps the
        # full labeling ladder (LRU / MeDiC / stale / oracle) through one
        # pool implementation
        if policy is None:
            if cfg.policy not in POOL_POLICIES:
                raise ValueError(f"unknown pool policy {cfg.policy!r}")
            policy = POOL_POLICIES[cfg.policy]
        self.policy = policy
        self.tables = DecisionTables.from_arrays(
            to_arrays(policy), cfg.rrip_max)
        # ① labeling mode + effective reclassification window: ``stale``
        # freezes each sequence's first classified label until the slot
        # is reset; ``oracle`` pins labels set via ``set_oracle_type``
        self.label_mode = policy.labeling
        self._interval = int(policy.reclass_interval
                             or cfg.sampling_interval)
        # residency table: one row per budgeted block
        cap = cfg.budget_blocks
        self._slot = np.full(cap, -1, np.int64)    # owner seq slot (-1 free)
        self._blk = np.full(cap, -1, np.int64)     # block index within owner
        self._rank = np.zeros(cap, np.int64)       # RRIP rank
        self._otype = np.full(cap, WT.BALANCED, np.int64)
        self._ins_seq = np.zeros(cap, np.int64)    # insertion order tie-break
        self._next_seq = 0
        self._row: Dict[Tuple[int, int], int] = {}  # key -> row (O(1) find)
        self._free = list(range(cap - 1, -1, -1))   # free rows (O(1) alloc)
        # classifier counters per slot (incl. pseudo-slots) (①)
        self.hits = np.zeros(max_seqs, np.int64)
        self.accesses = np.zeros(max_seqs, np.int64)
        self.win_hits = np.zeros(max_seqs, np.int64)
        self.win_acc = np.zeros(max_seqs, np.int64)
        self.seq_type = np.full(max_seqs, WT.BALANCED, np.int64)
        self.ratio = np.full(max_seqs, 0.5, np.float64)
        self._label_locked = np.zeros(max_seqs, bool)
        # two-queue transfer engine (④)
        self.hp_free = 0.0
        self.lp_free = 0.0
        # metrics: block keys looked up (hits and misses), misses
        self.lookups = 0
        self.fetches = 0
        self.qdelays: List[float] = []
        self.evictions_by_type = np.zeros(WT.NUM_TYPES, np.int64)
        self.bypassed_blocks = 0

    # -- residency table helpers ---------------------------------------------

    def _find(self, key: Tuple[int, int]) -> int:
        """Row index of `key`, or -1 (hash index kept beside the arrays)."""
        return self._row.get((int(key[0]), int(key[1])), -1)

    def is_resident(self, key: Tuple[int, int]) -> bool:
        return self._find(key) >= 0

    @property
    def resident(self) -> Dict[Tuple[int, int], int]:
        """Residency as a key->rank dict (insertion order), for
        introspection and the dict-parity tests."""
        rows = np.nonzero(self._slot >= 0)[0]
        rows = rows[np.argsort(self._ins_seq[rows], kind="stable")]
        return {(int(self._slot[i]), int(self._blk[i])): int(self._rank[i])
                for i in rows}

    # -- classification (①) -------------------------------------------------

    def _observe(self, slot: int, hit: bool):
        self.hits[slot] += hit
        self.accesses[slot] += 1
        self.win_hits[slot] += hit
        self.win_acc[slot] += 1
        if self.win_acc[slot] >= self._interval:
            r = self.win_hits[slot] / max(self.win_acc[slot], 1)
            self.ratio[slot] = r
            newt = WT.classify_np(
                r, int(self.win_acc[slot]),
                mostly_hit_threshold=self.cfg.mostly_hit_threshold,
                mostly_miss_threshold=self.cfg.mostly_miss_threshold,
                min_samples=1)
            self._relabel(slot, newt)
            self.win_hits[slot] = 0
            self.win_acc[slot] = 0

    def _relabel(self, slot: int, newt: int):
        """Apply one window's classification under the labeling mode."""
        if self.label_mode == "oracle":
            return                      # pinned via set_oracle_type
        if self.label_mode == "stale" and self._label_locked[slot]:
            return                      # first classified label sticks
        self.seq_type[slot] = newt
        self._label_locked[slot] = True

    def set_oracle_type(self, slot: int, stype: int):
        """Pin the slot's label to ground truth (``label_mode="oracle"``:
        set at admission from the request's true class; ``_observe``
        keeps counting stats but never relabels)."""
        self.seq_type[slot] = stype
        self._label_locked[slot] = True

    def reset_slot(self, slot: int):
        """New sequence admitted into the slot: drop its blocks + counters."""
        mine = np.nonzero(self._slot == slot)[0]
        self._slot[mine] = -1
        self._blk[mine] = -1
        self._free.extend(int(r) for r in mine)
        for key in [k for k in self._row if k[0] == slot]:
            del self._row[key]
        self.hits[slot] = self.accesses[slot] = 0
        self.win_hits[slot] = self.win_acc[slot] = 0
        self.seq_type[slot] = WT.BALANCED
        self.ratio[slot] = 0.5
        self._label_locked[slot] = False

    # -- the per-step residency transaction ----------------------------------

    def access(self, slot: int, blocks: List[int], now: float,
               resident_key: Optional[Tuple[int, int]] = None
               ) -> Tuple[float, List[int]]:
        """A decode step for sequence `slot` needs `blocks`. Returns
        (ready_time, fetched_block_list). Updates residency per policy.
        `resident_key` overrides the residency key (shared-prefix blocks
        live under a pseudo-slot while counting toward `slot`'s ratio)."""
        cfg = self.cfg
        tb = self.tables
        stype = int(self.seq_type[slot])
        ready = now
        fetched = []
        self.lookups += len(blocks)
        for blk in blocks:
            key = resident_key if resident_key is not None else (slot, blk)
            row = self._find(key)
            self._observe(slot, row >= 0)
            if row >= 0:
                # promotion: hit blocks move to rank 0 (MRU analogue)
                self._rank[row] = 0
                continue
            # ---- miss -> fetch through the two-queue scheduler (④) -------
            self.fetches += 1
            fetched.append(blk)
            if tb.hp_by_type[stype]:
                t0 = max(self.hp_free, now)
                self.hp_free = t0 + cfg.fetch_occupancy
            else:
                t0 = max(self.lp_free, self.hp_free, now)
                self.lp_free = t0 + cfg.fetch_occupancy
            self.qdelays.append(t0 - now)
            ready = max(ready, t0 + cfg.fetch_latency)
            # ---- insertion / bypass (②③) ---------------------------------
            if tb.bypass_by_type[stype]:
                self.bypassed_blocks += 1
                continue  # streamed: not retained
            self._insert(key, int(tb.rank_by_type[stype]), stype)
        return ready, fetched

    # -- batched residency transaction (one step, all active slots) ----------

    def access_batch(self, owner: np.ndarray, kslot: np.ndarray,
                     kblk: np.ndarray, now: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One serving step's residency transactions for every active
        slot at once. ``owner[q]`` is the sequence charged for access
        ``q`` (sorted ascending — slot-major order); ``(kslot, kblk)``
        is its residency key (shared-prefix blocks live under a
        pseudo-slot). Returns ``(slots, ready)``: the distinct owners in
        order and each one's fetch-ready time.

        Semantics are EXACTLY the sequential reference — calling
        ``access(owner[q], [kblk[q]], now, resident_key=...)`` for q in
        order, the call pattern ``ServeEngine.run`` makes — but the
        dominant all-hit traffic is handled in vectorized runs: one
        residency lookup for the whole batch (packed-code searchsorted
        against a step-start snapshot), one rank-promotion scatter and a
        closed-form multi-window classifier advance per run. Only
        segments with a miss (or whose snapshot was invalidated by a
        same-step eviction/insertion from an earlier slot) drop to the
        per-key path, so those interleavings stay bit-exact too.
        """
        owner = np.asarray(owner, np.int64)
        kslot = np.asarray(kslot, np.int64)
        kblk = np.asarray(kblk, np.int64)
        n = owner.size
        if n == 0:
            return np.empty(0, np.int64), np.empty(0, np.float64)
        cut = np.nonzero(np.diff(owner))[0] + 1
        starts = np.concatenate(([0], cut))
        ends = np.concatenate((cut, [n]))
        seg_owner = owner[starts].copy()
        ready = np.full(len(seg_owner), float(now))
        # step-start residency snapshot, packed-code sorted for lookup
        valid = np.nonzero(self._slot >= 0)[0]
        codes = self._slot[valid] * _BLK_STRIDE + self._blk[valid]
        order = np.argsort(codes)
        scodes, srows = codes[order], valid[order]
        qcodes = kslot * _BLK_STRIDE + kblk
        if len(scodes):
            pos = np.minimum(np.searchsorted(scodes, qcodes),
                             len(scodes) - 1)
            hit = scodes[pos] == qcodes
            hit_row = np.where(hit, srows[pos], -1)
        else:
            hit = np.zeros(n, bool)
            hit_row = np.full(n, -1, np.int64)
        cum = np.concatenate(([0], np.cumsum(hit)))
        seg_allhit = (cum[ends] - cum[starts]) == (ends - starts)
        # keys whose residency changed since the snapshot (same-step
        # evictions/insertions by earlier slots): code -> row or -1
        changed: Dict[int, int] = {}
        prev_evict = self.on_evict

        def _tracking_evict(key):
            changed[int(key[0]) * _BLK_STRIDE + int(key[1])] = -1
            prev_evict(key)

        si, n_seg = 0, len(seg_owner)
        while si < n_seg:
            if seg_allhit[si]:
                sj = si
                while sj < n_seg and seg_allhit[sj]:
                    sj += 1
                qs, qe = starts[si], ends[sj - 1]
                rows = hit_row[qs:qe]
                if changed:
                    ch = np.fromiter(changed, np.int64, len(changed))
                    bad = np.isin(qcodes[qs:qe], ch)
                    if bad.any():
                        # an earlier slot's eviction (or re-insertion of
                        # a shared block) moved keys in this run: demote
                        # the affected segments to the per-key path
                        badcum = np.concatenate(([0], np.cumsum(bad)))
                        for k in range(si, sj):
                            b0, b1 = starts[k] - qs, ends[k] - qs
                            if badcum[b1] > badcum[b0]:
                                seg_allhit[k] = False
                        continue
                self._rank[rows] = 0
                self.lookups += int(qe - qs)
                self._advance_hits(seg_owner[si:sj], ends[si:sj] -
                                   starts[si:sj])
                si = sj
            else:
                o = int(seg_owner[si])
                t = float(now)
                self.on_evict = _tracking_evict
                try:
                    for q in range(starts[si], ends[si]):
                        key = (int(kslot[q]), int(kblk[q]))
                        tq, _ = self.access(o, [int(kblk[q])], now,
                                            resident_key=key)
                        t = max(t, tq)
                        row = self._row.get(key)
                        if row is not None:
                            changed[int(qcodes[q])] = row
                finally:
                    self.on_evict = prev_evict
                ready[si] = t
                si += 1
        return seg_owner, ready

    def _advance_hits(self, slots: np.ndarray, counts: np.ndarray):
        """Classifier counters for ``counts[j]`` consecutive HIT observes
        of ``slots[j]`` — the closed form of ``_observe(slot, True)``
        repeated, including multi-window closes. ``slots`` must be
        distinct (one segment per owner, guaranteed by the sorted-owner
        segmentation in ``access_batch``)."""
        iv = self._interval
        k = np.asarray(counts, np.int64)
        a0 = self.win_acc[slots]
        h0 = self.win_hits[slots]
        tot = a0 + k
        self.hits[slots] += k
        self.accesses[slots] += k
        n_close = tot // iv
        rem = tot % iv
        closing = n_close > 0
        if closing.any():
            cs = slots[closing]
            # the first closed window carries the pre-step partial
            # counters; later ones are pure-hit (ratio 1). The LAST
            # close sets the diagnostic ratio; label updates replay the
            # per-window order (stale locks on the first close).
            first_r = (h0[closing] + (iv - a0[closing])) / iv
            last_r = np.where(n_close[closing] >= 2, 1.0, first_r)
            thr = dict(mostly_hit_threshold=self.cfg.mostly_hit_threshold,
                       mostly_miss_threshold=self.cfg.mostly_miss_threshold)
            t_first = WT._ladder_np(first_r, **thr)
            t_last = WT._ladder_np(last_r, **thr)
            self.ratio[cs] = last_r
            if self.label_mode == "online":
                self.seq_type[cs] = t_last
                self._label_locked[cs] = True
            elif self.label_mode == "stale":
                unlocked = ~self._label_locked[cs]
                self.seq_type[cs[unlocked]] = t_first[unlocked]
                self._label_locked[cs[unlocked]] = True
            # oracle: labels pinned via set_oracle_type
            self.win_hits[cs] = rem[closing]   # open window is all-hit
            self.win_acc[cs] = rem[closing]
        nc = ~closing
        if nc.any():
            self.win_hits[slots[nc]] = tot[nc] - (a0[nc] - h0[nc])
            self.win_acc[slots[nc]] = tot[nc]

    def _insert(self, key, rank: int, stype: int):
        cfg = self.cfg
        n = len(self._row)                       # resident count, O(1)
        while n >= cfg.budget_blocks:
            self._evict_one()
            n -= 1
        # age everyone mildly on insertion pressure (RRIP-flavoured) —
        # one vectorized clamp, and only when actually near budget
        if n >= cfg.budget_blocks - 1:
            valid = self._slot >= 0
            self._rank[valid] = np.minimum(self._rank[valid] + 1,
                                           cfg.rrip_max)
        row = self._find(key)
        if row < 0:
            row = self._free.pop()
            self._slot[row], self._blk[row] = key
            self._ins_seq[row] = self._next_seq
            self._next_seq += 1
            self._row[(int(key[0]), int(key[1]))] = row
        self._rank[row] = rank
        self._otype[row] = stype

    def _evict_one(self):
        """Evict the max-rank resident; ties break to the earliest-inserted
        (the reference dict's iteration order)."""
        valid = self._slot >= 0
        ranked = np.where(valid, self._rank, -1)
        cand = np.nonzero(ranked == ranked.max())[0]
        victim = int(cand[np.argmin(self._ins_seq[cand])])
        vt = int(self._otype[victim])
        self.evictions_by_type[vt] += 1
        key = (int(self._slot[victim]), int(self._blk[victim]))
        self._slot[victim] = -1
        self._blk[victim] = -1
        self._row.pop(key, None)
        self._free.append(victim)
        self.on_evict(key)

    def insert_prefill(self, key, stype: int):
        """Blocks produced on-device at prefill: no fetch cost, but they
        enter the pool under the insertion/bypass policy."""
        tb = self.tables
        if tb.bypass_by_type[stype]:
            self.bypassed_blocks += 1
            self.on_evict(key)   # streamed immediately (not retained)
            return
        self._insert(key, int(tb.rank_by_type[stype]), stype)

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
            "resident_blocks": int((self._slot >= 0).sum()),
            "evictions_by_type": self.evictions_by_type.copy(),
        }
