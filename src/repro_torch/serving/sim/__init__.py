"""Vectorized continuous-batching serving simulator (open-loop traffic),
the port of ``repro.serving.sim``: host-side numpy in float64 and int64,
as in the reference, so its outputs are equal to the reference's bit for
bit (tests/test_torch_serving_sim.py). It has no data path and runs no
kernel; the card's ``ServeEngine`` is what it is held against.

The timing/accounting view of ``serving.engine.ServeEngine``: the same
admission / residency / decode-commit step semantics, advanced over
fixed-capacity arrays so thousands of concurrent requests are one step's
work, driven by deterministic counter-RNG arrival processes instead of a
fixed closed-loop request list. ``ServeEngine`` remains the real-data-
path reference; the parity suite pins the two on closed-loop workloads.
"""
from repro_torch.serving.sim.arrivals import (arrival_times,
                                              from_requests,
                                              generate_serving)
from repro_torch.serving.sim.metrics import summarize
from repro_torch.serving.sim.spec import SERVING_SPECS, ServingSpec
from repro_torch.serving.sim.state import ServingState, init_state
from repro_torch.serving.sim.step import POOL_BACKENDS, simulate_serving

__all__ = [
    "ServingSpec", "SERVING_SPECS", "ServingState", "init_state",
    "arrival_times", "generate_serving", "from_requests",
    "simulate_serving", "POOL_BACKENDS", "summarize",
]
