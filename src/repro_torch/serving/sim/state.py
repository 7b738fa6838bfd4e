"""Fixed-capacity array state for the serving simulator.

One ``ServingState`` holds the whole population: a request axis [R]
(arrival attributes + lifecycle timestamps) and a slot axis [S]
(occupancy, fetch-readiness, KV length) — the serving analogue of the
wavefront engine's SimState. Everything the step function touches is a
numpy array, so admission / residency / decode-commit operate on slot
populations, not Python request objects.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.serving.sim.spec import ServingSpec


@dataclasses.dataclass
class ServingState:
    """Mutable array state of one serving run."""
    # request axis [R] — arrival attributes (read-only after init)
    arrival: np.ndarray        # f64[R] arrival time (engine steps)
    prompt_len: np.ndarray     # i64[R] unique prompt tokens
    decode_len: np.ndarray     # i64[R] tokens to generate
    prefix_id: np.ndarray      # i64[R] shared-prefix id (-1 = RAG)
    prefix_len: np.ndarray     # i64[R] shared-prefix tokens (0 = RAG)
    # request axis [R] — lifecycle (engine-step stamps, -1 = not yet)
    enqueue_step: np.ndarray   # i64[R] admission step
    first_token_step: np.ndarray
    finish_step: np.ndarray
    generated: np.ndarray      # i64[R] tokens generated so far
    stall_steps: np.ndarray    # i64[R] steps spent fetch-stalled
    # slot axis [S]
    slot_req: np.ndarray       # i64[S] request in the slot (-1 = free)
    ready_at: np.ndarray       # f64[S] earliest step the slot may decode
    cache_len: np.ndarray      # i64[S] KV tokens held (prefill + decoded)
    fetch_pending: np.ndarray  # bool[S] stalled decode commits at ready_at
    # admission queue: request ids sorted by (arrival, id) — the stable
    # order ``ServeEngine.run``'s ``sorted(requests, key=arrival)`` uses
    order: np.ndarray          # i64[R]
    arr_sorted: np.ndarray     # f64[R] arrival[order] (admission cursor)
    qhead: int = 0
    # counters
    step: int = 0
    tokens_out: int = 0
    n_finished: int = 0
    # per-step samples (concurrency metrics / Little's-law checks)
    occ_steps: int = 0         # Σ occupied slots over steps
    sys_steps: int = 0         # Σ in-system (queued + occupied) requests
    max_concurrency: int = 0   # peak occupied slots
    max_in_system: int = 0

    @property
    def n_requests(self) -> int:
        return int(self.arrival.shape[0])

    @property
    def max_slots(self) -> int:
        return int(self.slot_req.shape[0])

    def pending(self) -> bool:
        """Anything left to do (mirrors the ServeEngine loop guard)?"""
        return self.qhead < self.n_requests or bool(
            (self.slot_req >= 0).any())


def init_state(reqs: Dict[str, np.ndarray], spec: ServingSpec
               ) -> ServingState:
    """Fresh state for one request stream (``arrivals.generate_serving``
    or ``arrivals.from_requests`` arrays)."""
    r = len(reqs["arrival"])
    order = np.argsort(reqs["arrival"], kind="stable").astype(np.int64)
    neg1 = lambda n: np.full(n, -1, np.int64)  # noqa: E731
    return ServingState(
        arrival=np.asarray(reqs["arrival"], np.float64),
        prompt_len=np.asarray(reqs["prompt_len"], np.int64),
        decode_len=np.asarray(reqs["decode_len"], np.int64),
        prefix_id=np.asarray(reqs["prefix_id"], np.int64),
        prefix_len=np.asarray(reqs["prefix_len"], np.int64),
        enqueue_step=neg1(r),
        first_token_step=neg1(r),
        finish_step=neg1(r),
        generated=np.zeros(r, np.int64),
        stall_steps=np.zeros(r, np.int64),
        slot_req=neg1(spec.max_slots),
        ready_at=np.zeros(spec.max_slots, np.float64),
        cache_len=np.zeros(spec.max_slots, np.int64),
        fetch_pending=np.zeros(spec.max_slots, bool),
        order=order,
        arr_sorted=np.asarray(reqs["arrival"], np.float64)[order],
    )
