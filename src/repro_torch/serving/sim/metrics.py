"""Serving metrics computed from state arrays.

Everything here is a float/int scalar so a metrics dict can ride the
declarative ``api`` result path (``ResultSet`` stacks scalars across
policies x seeds). Conventions:

  * ``latency``       finish - ARRIVAL (the open-loop, user-visible
                      number: queue wait included);
  * ``service_lat``   finish - enqueue (the closed-loop number the
                      ServeEngine snapshot calls "latency");
  * ``queue_wait``    enqueue - arrival, its own metric (satellite fix:
                      the engine used to fold this into nothing);
  * ``ttft``          first token - enqueue;
  * ``goodput``       tokens/step from COMPLETED requests only — tokens
                      poured into a request that never finishes within
                      the horizon don't count;
  * ``stall_steps``   includes in-flight requests, not just completed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.serving.pool import MedicPoolManager
from repro_torch.serving.sim.spec import ServingSpec
from repro_torch.serving.sim.state import ServingState


def _pct(x: np.ndarray, q: float) -> float:
    return float(np.percentile(x, q)) if x.size else float("nan")


def _mean(x: np.ndarray) -> float:
    return float(np.mean(x)) if x.size else float("nan")


def summarize(state: ServingState, pool: MedicPoolManager,
              spec: ServingSpec) -> Dict[str, float]:
    done = state.finish_step >= 0
    admitted = state.enqueue_step >= 0
    first = state.first_token_step >= 0
    steps = max(state.step, 1)

    lat = state.finish_step[done] - state.arrival[done]
    service = (state.finish_step[done] -
               state.enqueue_step[done]).astype(np.float64)
    qwait = state.enqueue_step[admitted] - state.arrival[admitted]
    ttft = (state.first_token_step[first] -
            state.enqueue_step[first]).astype(np.float64)

    # censored tail: requests still in flight (or still queued) at the
    # horizon count at their latency-so-far lower bound, so a truncated
    # run cannot flatter a policy by completing only its easy requests
    seen = state.arrival <= state.step
    cens = np.where(state.finish_step >= 0,
                    state.finish_step - state.arrival,
                    state.step - state.arrival)[seen]

    acc = int(pool.accesses[:spec.max_slots].sum())
    hits = int(pool.hits[:spec.max_slots].sum())
    evictions = int(pool.evictions_by_type.sum())
    return {
        "completed": int(done.sum()),
        "admitted": int(admitted.sum()),
        "steps": int(state.step),
        "tokens_out": int(state.tokens_out),
        "throughput": state.tokens_out / steps,
        "goodput": float(state.decode_len[done].sum()) / steps,
        "mean_latency": _mean(lat),
        "p50_latency": _pct(lat, 50),
        "p99_latency": _pct(lat, 99),
        "p99_latency_censored": _pct(cens, 99),
        "mean_service_latency": _mean(service),
        "p99_service_latency": _pct(service, 99),
        "mean_queue_wait": _mean(qwait),
        "p99_queue_wait": _pct(qwait, 99),
        "mean_ttft": _mean(ttft),
        "p99_ttft": _pct(ttft, 99),
        "stall_steps": int(state.stall_steps.sum()),
        "fetches": int(pool.fetches),
        "bypassed_blocks": int(pool.bypassed_blocks),
        "evictions": evictions,
        "eviction_churn": evictions / steps,
        "hit_ratio": hits / max(acc, 1),
        "mean_concurrency": state.occ_steps / steps,
        "max_concurrency": int(state.max_concurrency),
        "mean_in_system": state.sys_steps / steps,
        "max_in_system": int(state.max_in_system),
    }
