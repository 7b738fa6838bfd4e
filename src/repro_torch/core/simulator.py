"""Altitude-A faithful MeDiC simulator (paper §3, evaluated as §5) —
facade over the ``repro_torch.core.engine`` subsystem (the port of
``repro.core.simulator``).

A request-level discrete-event model of the GPU shared memory hierarchy:
warps in lockstep issuing coalesced line requests (memory divergence), a
banked set-associative shared L2 with per-bank service queues, RRIP
replacement whose insertion rank the policy controls (③), DRAM channels
with open-row buffers and a two-queue FR-FCFS scheduler (④), warp-type
identification (①) and warp-type-aware bypassing (②).

Two engines share the state and per-request math: ``engine="event"``
(default) is the exact chronological discrete-event loop (one
hand-written CUDA kernel on the card); ``engine="wavefront"`` is the
batched round-lockstep loop that runs the stress matrix (two CUDA
kernels a wave). Both run on the card unless the caller passes
``device="cpu"``.

This module re-exports the public API; the implementation lives in
``repro_torch/core/engine/``.
"""
from __future__ import annotations

from repro_torch.core.engine import (ENGINES, N_QBINS, SimParams, SimState,
                                     init_state, simulate, simulate_sweep)
from repro_torch.core.engine.event import _request_step, simulate_core \
    as _simulate_core
from repro_torch.policy import Policy, PolicyArrays

__all__ = [
    "ENGINES", "N_QBINS", "Policy", "PolicyArrays", "SimParams",
    "SimState", "init_state", "simulate", "simulate_sweep",
    "_request_step", "_simulate_core",
]
