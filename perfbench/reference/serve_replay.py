"""Plain replay of a serving engine's control flow, the reference for a
serving cell's pool and scheduling counters.

The engine's decisions do not depend on the model: admissions in
arrival order into free slots, one residency transaction a block of each
ready sequence before every decode step (hits, fetches through a
two-queue transfer model, bypass or insertion of the fetched block under
the pool's policy, eviction of the highest rank), stalls until fetches
land, a token for every active sequence, and streamed blocks leaving
the device again. This module walks the same steps on a dict-based pool,
written from the MeDiC pool's stated semantics (per-sequence hit-ratio
windows, the five-type ladder, RRIP-flavoured ranks with aging on
insertion pressure, ties to the earliest inserted), and stops where the
measured window stopped: before the decode step or admission that found
the window closed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

ALL_MISS, MOSTLY_MISS, BALANCED, MOSTLY_HIT, ALL_HIT = range(5)
NUM_TYPES = 5
#: pseudo-slots for shared prefixes, after the real slots
PSEUDO_SLOTS = 8


def classify(ratio: float, mostly_hit: float, mostly_miss: float) -> int:
    """The five-type ladder on a float32 hit ratio."""
    r = np.float32(ratio)
    t = BALANCED
    if r <= np.float32(mostly_miss):
        t = MOSTLY_MISS
    if r <= np.float32(1e-6):
        t = ALL_MISS
    if r >= np.float32(mostly_hit):
        t = MOSTLY_HIT
    if r >= np.float32(1.0 - 1e-6):
        t = ALL_HIT
    return t


class DictPool:
    """Block residency under a budget, with MeDiC's (``medic``) or plain
    LRU-rank (``lru``) decisions."""

    def __init__(self, cfg: Mapping, max_seqs: int, on_evict):
        self.cfg = cfg
        self.medic = cfg["policy"] == "medic"
        self.on_evict = on_evict
        self.resident: Dict[Tuple[int, int], int] = {}
        self.owner_type: Dict[Tuple[int, int], int] = {}
        self.hits = [0] * max_seqs
        self.accesses = [0] * max_seqs
        self.win_hits = [0] * max_seqs
        self.win_acc = [0] * max_seqs
        self.seq_type = [BALANCED] * max_seqs
        self.hp_free = self.lp_free = 0.0
        self.fetches = self.bypassed_blocks = 0
        self.evictions_by_type = [0] * NUM_TYPES

    def _observe(self, slot: int, hit: bool) -> None:
        self.hits[slot] += hit
        self.accesses[slot] += 1
        self.win_hits[slot] += hit
        self.win_acc[slot] += 1
        if self.win_acc[slot] >= self.cfg["sampling_interval"]:
            self.seq_type[slot] = classify(
                self.win_hits[slot] / max(self.win_acc[slot], 1),
                self.cfg["mostly_hit_threshold"],
                self.cfg["mostly_miss_threshold"])
            self.win_hits[slot] = self.win_acc[slot] = 0

    def reset_slot(self, slot: int) -> None:
        for key in [k for k in self.resident if k[0] == slot]:
            del self.resident[key]
            self.owner_type.pop(key, None)
        self.hits[slot] = self.accesses[slot] = 0
        self.win_hits[slot] = self.win_acc[slot] = 0
        self.seq_type[slot] = BALANCED

    def _rank(self, stype: int) -> int:
        if not self.medic:
            return 0
        top = self.cfg["rrip_max"] - 1
        return 0 if stype >= MOSTLY_HIT else top - 1 if stype == BALANCED \
            else top

    def access(self, slot: int, key: Tuple[int, int], now: float
               ) -> Tuple[float, bool]:
        """One block of sequence ``slot``: (ready time, fetched)."""
        stype = self.seq_type[slot]
        hit = key in self.resident
        self._observe(slot, hit)
        if hit:
            self.resident[key] = 0
            return now, False
        self.fetches += 1
        if self.medic and stype >= MOSTLY_HIT:
            t0 = max(self.hp_free, now)
            self.hp_free = t0 + self.cfg["fetch_occupancy"]
        else:
            t0 = max(self.lp_free, self.hp_free, now)
            self.lp_free = t0 + self.cfg["fetch_occupancy"]
        ready = max(now, t0 + self.cfg["fetch_latency"])
        if self.medic and stype <= MOSTLY_MISS:
            self.bypassed_blocks += 1
        else:
            self._insert(key, self._rank(stype), stype)
        return ready, True

    def _insert(self, key, rank: int, stype: int) -> None:
        budget = self.cfg["budget_blocks"]
        while len(self.resident) >= budget:
            victim = max(self.resident.items(), key=lambda kv: kv[1])[0]
            self.evictions_by_type[self.owner_type.pop(victim, BALANCED)] \
                += 1
            del self.resident[victim]
            self.on_evict(victim)
        if len(self.resident) >= budget - 1:
            for k in self.resident:
                self.resident[k] = min(self.resident[k] + 1,
                                       self.cfg["rrip_max"])
        self.resident[key] = rank
        self.owner_type[key] = stype

    def insert_prefill(self, key, stype: int) -> None:
        if self.medic and stype <= MOSTLY_MISS:
            self.bypassed_blocks += 1
            self.on_evict(key)
            return
        self._insert(key, self._rank(stype), stype)


@dataclasses.dataclass
class Seq:
    rid: int
    prompt_len: int
    decode_len: int
    shared_prefix_id: Optional[int]
    shared_prefix_len: int
    arrival: float
    slot: int = -1
    generated: int = 0
    stall_steps: int = 0
    enqueue_step: int = 0
    first_token_step: int = -1
    finish_step: int = -1


def replay(requests, engine: Mapping, pool_cfg: Mapping,
           stop: Tuple[str, int]) -> dict:
    """Walk the engine's loop over ``requests`` until the event ``stop``:
    ``("decode", n)`` stops before the (n+1)-th decode step, ``("admit",
    n)`` before the (n+1)-th admission. Returns the requests admitted,
    the pool and the engine's counts."""
    n_slots, max_len = engine["max_slots"], engine["max_len"]
    bs = pool_cfg["block_tokens"]
    store: set = set()
    counts = dict(admissions=0, decode_steps=0, offloads=0, restores=0)

    def offload(key):
        if key[0] < n_slots:
            store.add(key)
            counts["offloads"] += 1

    def restore(key):
        if key[0] < n_slots and key in store:
            counts["restores"] += 1

    pool = DictPool(pool_cfg, n_slots + PSEUDO_SLOTS, offload)
    seqs = [Seq(**dataclasses.asdict(r)) for r in requests]
    pending = sorted(seqs, key=lambda r: r.arrival)
    slots: List[Optional[Seq]] = [None] * n_slots
    lens = [0] * n_slots
    ready_at = [0.0] * n_slots
    fetch_pending = [False] * n_slots
    admitted: List[Seq] = []

    def block_keys(req: Seq, length: int):
        shared = req.shared_prefix_id is not None
        nshared = req.shared_prefix_len // bs if shared else 0
        return [(n_slots + req.shared_prefix_id, i) if i < nshared
                else (req.slot, i) for i in range(math.ceil(length / bs))]

    def result():
        return dict(admitted=admitted, pool=pool, counts=counts,
                    resident=len(pool.resident))

    step = 0
    while pending or any(slots):
        now = float(step)
        for i in range(n_slots):
            if slots[i] is None and pending and pending[0].arrival <= now:
                if stop == ("admit", counts["admissions"]):
                    return result()
                req = pending.pop(0)
                req.slot, req.enqueue_step = i, step
                slots[i] = req
                admitted.append(req)
                pool.reset_slot(i)
                for key in [k for k in store if k[0] == i]:
                    store.discard(key)
                n_tok = req.prompt_len + (req.shared_prefix_len if
                                          req.shared_prefix_id is not None
                                          else 0)
                lens[i] = n_tok
                counts["admissions"] += 1
                stype = pool.seq_type[i]
                for key in block_keys(req, n_tok):
                    pool.insert_prefill(key, stype)
                ready_at[i] = now
                fetch_pending[i] = False
        active = [False] * n_slots
        for i, req in enumerate(slots):
            if req is None or ready_at[i] > now:
                if req is not None:
                    req.stall_steps += 1
                continue
            if fetch_pending[i]:
                fetch_pending[i] = False
                active[i] = True
                continue
            t_ready = now
            for key in block_keys(req, min(lens[i] + 1, max_len)):
                t, fetched = pool.access(i, key, now)
                if fetched:
                    restore(key)
                t_ready = max(t_ready, t)
            if t_ready > now:
                ready_at[i] = t_ready
                fetch_pending[i] = True
                req.stall_steps += 1
            else:
                active[i] = True
        if any(active):
            if stop == ("decode", counts["decode_steps"]):
                return result()
            counts["decode_steps"] += 1
            for i in range(n_slots):
                if active[i]:
                    lens[i] += 1
            for i, req in enumerate(slots):
                if req is None or not active[i]:
                    continue
                req.generated += 1
                if req.first_token_step < 0:
                    req.first_token_step = step
                if req.generated >= req.decode_len:
                    req.finish_step = step
                    slots[i] = None
            for i, req in enumerate(slots):
                if req is None or not active[i]:
                    continue
                for key in block_keys(req, min(lens[i], max_len)):
                    if key not in pool.resident and key in store:
                        offload(key)
        step += 1
    return result()


#: per-request fields compared with the program's
REQUEST_FIELDS = ("slot", "enqueue_step", "generated", "stall_steps",
                  "first_token_step", "finish_step")


def compare(program: Mapping, ref: Mapping) -> List[str]:
    """The counters on which the program and the replay differ.
    ``program`` holds ``requests`` ({rid: {field: value}}), ``pool``
    (fetches, bypassed_blocks, evictions_by_type, resident_blocks,
    seq_type, hits, accesses) and ``counts`` (admissions, decode_steps,
    offloads, restores)."""
    off = []
    got = program["requests"]
    want = {r.rid: r for r in ref["admitted"]}
    if set(got) != set(want):
        off.append(f"admitted rids differ: {len(got)} vs {len(want)}")
    for rid in sorted(set(got) & set(want)):
        for f in REQUEST_FIELDS:
            if got[rid][f] != getattr(want[rid], f):
                off.append(f"request {rid} {f}: {got[rid][f]} vs "
                           f"{getattr(want[rid], f)}")
    pool, pp = ref["pool"], program["pool"]
    for f, v in (("fetches", pool.fetches),
                 ("bypassed_blocks", pool.bypassed_blocks),
                 ("evictions_by_type", pool.evictions_by_type),
                 ("resident_blocks", ref["resident"]),
                 ("seq_type", pool.seq_type), ("hits", pool.hits),
                 ("accesses", pool.accesses)):
        a = np.asarray(pp[f]).reshape(-1).tolist()
        b = np.asarray(v).reshape(-1).tolist()
        if a != b:
            off.append(f"pool {f}: {a[:8]} vs {b[:8]}")
    for f, v in ref["counts"].items():
        if program["counts"][f] != v:
            off.append(f"engine {f}: {program['counts'][f]} vs {v}")
    return off
