"""Batched admission -> residency -> decode-commit serving step.

One ``sim_step`` advances EVERY slot of a ``ServingState`` through the
exact per-step semantics of ``ServeEngine.run`` — same admission order
(free slots in index order paired with the arrival-sorted queue head),
same stall accounting (waiting on an in-flight fetch AND newly stalled
both count), same residency transaction per block key, same decode
commit (``cache_len`` grows only on active slots) — but expressed over
arrays. The pool transaction itself goes through
``MedicPoolManager.access_batch`` (one call covering all active slots,
``pool_backend="fast"``) or the sequential per-key reference loop
(``"ref"``); a differential suite pins fast == ref bitwise, and a
closed-loop parity suite pins ref == ServeEngine per request
(tests/test_torch_serving_sim*.py, and ``chip_smoke.py`` against the
full-width engine on the card).

The simulator has no data path (no model, no KV payloads) — it is the
timing/accounting view of the engine, which is what makes thousands of
concurrent slots per step affordable.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import warp_types as WT
from repro_torch.policy import Policy
from repro_torch.serving.pool import MedicPoolManager
from repro_torch.serving.sim import metrics as sim_metrics
from repro_torch.serving.sim.spec import ServingSpec
from repro_torch.serving.sim.state import ServingState, init_state

POOL_BACKENDS = ("auto", "ref", "fast")


def _block_keys_arrays(state: ServingState, spec: ServingSpec,
                       slots: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Residency keys for this step's decode on ``slots`` (ascending).

    Returns ``(owner, kslot, kblk)`` flat arrays in slot-major, block-
    ascending order — the exact key sequence ``ServeEngine.run`` emits:
    the first ``shared_prefix_len // block_tokens`` blocks of a chat
    sequence live under the prefix's pseudo-slot ``max_slots + pid``.
    """
    bs = spec.block_tokens
    rid = state.slot_req[slots]
    length = np.minimum(state.cache_len[slots] + 1, spec.max_len)
    nblk = -(-length // bs)
    owner = np.repeat(slots, nblk)
    seg_start = np.concatenate(([0], np.cumsum(nblk)[:-1]))
    kblk = np.arange(owner.size, dtype=np.int64) - np.repeat(seg_start, nblk)
    pid = state.prefix_id[rid]
    nshared = np.where(pid >= 0, state.prefix_len[rid] // bs, 0)
    kslot = np.where(kblk < np.repeat(nshared, nblk),
                     spec.max_slots + np.repeat(pid, nblk), owner)
    return owner, kslot, kblk


def _admit(state: ServingState, spec: ServingSpec,
           pool: MedicPoolManager, now: float):
    """Admit queued requests into free slots — free slots in index order
    each take the arrival-sorted queue head, exactly the ServeEngine
    scan. Prefill is accounting-only: reset the slot, (oracle mode) pin
    the true label, then ``insert_prefill`` every prompt block."""
    n_arr = int(np.searchsorted(state.arr_sorted, now, side="right"))
    avail = n_arr - state.qhead
    if avail <= 0:
        return
    free = np.nonzero(state.slot_req < 0)[0]
    take = min(avail, free.size)
    if take <= 0:
        return
    oracle = pool.label_mode == "oracle"
    for j in range(take):
        slot = int(free[j])
        rid = int(state.order[state.qhead + j])
        state.slot_req[slot] = rid
        state.enqueue_step[rid] = state.step
        state.ready_at[slot] = now
        state.fetch_pending[slot] = False
        pool.reset_slot(slot)
        if oracle:
            # ground truth the classifier only estimates: chat sequences
            # (shared-hot prefix) are MOSTLY_HIT, RAG streams MOSTLY_MISS
            chat = state.prefix_id[rid] >= 0
            pool.set_oracle_type(
                slot, WT.MOSTLY_HIT if chat else WT.MOSTLY_MISS)
        plen = int(state.prefix_len[rid] + state.prompt_len[rid])
        state.cache_len[slot] = plen
        stype = int(pool.seq_type[slot])
        bs = spec.block_tokens
        nshared = int(state.prefix_len[rid]) // bs \
            if state.prefix_id[rid] >= 0 else 0
        pid = int(state.prefix_id[rid])
        for i in range(-(-plen // bs)):
            key = (spec.max_slots + pid, i) if i < nshared else (slot, i)
            pool.insert_prefill(key, stype)
    state.qhead += take


def _access_ref(pool: MedicPoolManager, owner: np.ndarray,
                kslot: np.ndarray, kblk: np.ndarray, now: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Sequential per-key reference transaction — the literal
    ``ServeEngine.run`` call pattern, one ``pool.access`` per block."""
    cut = np.nonzero(np.diff(owner))[0] + 1
    starts = np.concatenate(([0], cut))
    ends = np.concatenate((cut, [owner.size]))
    seg_owner = owner[starts].copy()
    ready = np.full(len(seg_owner), float(now))
    for si in range(len(seg_owner)):
        o = int(seg_owner[si])
        t = float(now)
        for q in range(starts[si], ends[si]):
            tq, _ = pool.access(o, [int(kblk[q])], now,
                                resident_key=(int(kslot[q]), int(kblk[q])))
            t = max(t, tq)
        ready[si] = t
    return seg_owner, ready


def sim_step(state: ServingState, spec: ServingSpec,
             pool: MedicPoolManager, fast: bool) -> None:
    """One engine step: admission, residency, decode-commit."""
    now = float(state.step)
    _admit(state, spec, pool, now)

    occupied = state.slot_req >= 0
    occ = int(occupied.sum())
    n_arr = int(np.searchsorted(state.arr_sorted, now, side="right"))
    state.occ_steps += occ
    state.sys_steps += n_arr - state.n_finished
    state.max_concurrency = max(state.max_concurrency, occ)
    state.max_in_system = max(state.max_in_system,
                              n_arr - state.n_finished)

    # waiting on an in-flight fetch: stalled, no residency transaction
    waiting = occupied & (state.ready_at > now)
    if waiting.any():
        wr = state.slot_req[waiting]
        state.stall_steps[wr] += 1

    eligible = occupied & (state.ready_at <= now)
    # a stalled slot's fetches landed: its delayed decode commits with
    # the streamed data — no second residency transaction (re-accessing
    # would re-miss bypassed blocks forever and livelock the miss class)
    landing = np.nonzero(eligible & state.fetch_pending)[0]
    transact = np.nonzero(eligible & ~state.fetch_pending)[0]
    state.fetch_pending[landing] = False
    if landing.size == 0 and transact.size == 0:
        state.step += 1
        return
    if transact.size:
        owner, kslot, kblk = _block_keys_arrays(state, spec, transact)
        if fast:
            seg_owner, ready = pool.access_batch(owner, kslot, kblk, now)
        else:
            seg_owner, ready = _access_ref(pool, owner, kslot, kblk, now)
        # every eligible slot holds >= 1 block, so segments == transact
        t_ready = np.asarray(ready)
        stalled = t_ready > now
        if stalled.any():
            ss = seg_owner[stalled]
            state.ready_at[ss] = t_ready[stalled]
            state.fetch_pending[ss] = True
            state.stall_steps[state.slot_req[ss]] += 1
        decoded = seg_owner[~stalled]
    else:
        decoded = np.empty(0, np.int64)
    active = np.sort(np.concatenate((landing, decoded)))
    if active.size:
        ar = state.slot_req[active]
        state.generated[ar] += 1
        state.tokens_out += int(active.size)
        newly = state.first_token_step[ar] < 0
        state.first_token_step[ar[newly]] = state.step
        state.cache_len[active] += 1
        fin = state.generated[ar] >= state.decode_len[ar]
        if fin.any():
            fr = ar[fin]
            state.finish_step[fr] = state.step
            state.slot_req[active[fin]] = -1
            state.n_finished += int(fin.sum())
    state.step += 1


def simulate_serving(reqs: Dict[str, np.ndarray], spec: ServingSpec,
                     policy: Optional[Policy] = None,
                     pool_backend: str = "auto",
                     max_steps: Optional[int] = None
                     ) -> Dict[str, object]:
    """Run one serving scenario to completion (or ``max_steps``).

    ``reqs`` is a request-stream dict (``arrivals.generate_serving`` /
    ``from_requests``); ``policy`` a unified-engine ``Policy`` preset
    (None -> the pool's ``medic`` default); ``pool_backend`` selects the
    vectorized (``fast``) or sequential-reference (``ref``) pool
    transaction (``auto`` -> fast). Returns ``{"metrics": scalars,
    "request_arrays": per-request lifecycle arrays, "pool": counters}``.
    """
    if pool_backend not in POOL_BACKENDS:
        raise ValueError(f"unknown pool_backend {pool_backend!r}; "
                         f"choose from {POOL_BACKENDS}")
    fast = pool_backend != "ref"
    state = init_state(reqs, spec)
    pool = MedicPoolManager(spec.pool_config(),
                            spec.max_slots + spec.n_pseudo_slots,
                            policy=policy)
    limit = int(max_steps if max_steps is not None else spec.max_steps)
    while state.pending() and state.step < limit:
        sim_step(state, spec, pool, fast)
    return {
        "metrics": sim_metrics.summarize(state, pool, spec),
        "request_arrays": {
            "enqueue_step": state.enqueue_step.copy(),
            "first_token_step": state.first_token_step.copy(),
            "finish_step": state.finish_step.copy(),
            "generated": state.generated.copy(),
            "stall_steps": state.stall_steps.copy(),
        },
        "pool": {
            "fetches": pool.fetches,
            "bypassed_blocks": pool.bypassed_blocks,
            "hits": pool.hits.copy(),
            "accesses": pool.accesses.copy(),
            "seq_type": pool.seq_type.copy(),
            "evictions_by_type": pool.evictions_by_type.copy(),
            "resident_blocks": int((pool._slot >= 0).sum()),
        },
    }
