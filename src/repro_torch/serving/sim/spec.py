"""ServingSpec: a named, hashable description of one serving scenario.

The serving analogue of ``tracegen.TraceSpec``: everything needed to
materialize an open-loop request stream (arrival process + population
mix) plus the engine/pool shape it runs against. Immutable and hashable
so ``api.Scenario`` can carry it and the plan compiler can bucket it.

``SERVING_SPECS`` is the named family the registry exposes — quick
64-slot A/B scenarios for CI plus the traffic-scale 2048-slot Poisson
spec the acceptance criterion names.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.serving.pool import PoolConfig

PROCESSES = ("poisson", "bursty", "diurnal", "closed")


@dataclasses.dataclass(frozen=True)
class ServingSpec:
    """One serving scenario: arrival process × request mix × pool shape.

    Arrival processes are all inhomogeneous Poisson streams generated by
    warping a unit-rate counter-RNG Poisson process through the inverse
    integrated rate (``arrivals.py``), so every process shares one
    deterministic, seed-stackable construction:

      * ``poisson`` — constant ``rate``;
      * ``bursty``  — MMPP-style square-wave rate: ``rate * burst_boost``
        for ``burst_duty`` of each ``burst_period``, scaled so the MEAN
        rate stays ``rate``;
      * ``diurnal`` — sinusoidal rate ``rate * (1 + amp·sin)``;
      * ``closed``  — every request arrives at t=0 (the closed-loop
        degenerate case the ServeEngine parity suite pins).
    """
    name: str
    process: str = "poisson"
    rate: float = 2.0                  # mean arrivals per engine step
    n_requests: int = 256
    burst_period: float = 64.0
    burst_duty: float = 0.25
    burst_boost: float = 3.0
    diurnal_period: float = 512.0
    diurnal_amp: float = 0.8
    # request population (mirrors request.ServeWorkload)
    chat_frac: float = 0.8
    n_shared_prefixes: int = 2
    shared_prefix_len: int = 48
    chat_prompt: Tuple[int, int] = (16, 48)
    rag_prompt: Tuple[int, int] = (192, 384)
    decode: Tuple[int, int] = (16, 48)
    # engine + pool shape
    max_slots: int = 64
    max_len: int = 448
    block_tokens: int = 16
    budget_blocks: int = 224
    sampling_interval: int = 32
    fetch_latency: float = 4.0
    # transfer-engine occupancy per block: the sustainable fetch
    # throughput is 1/occupancy blocks per step, so scale it with the
    # slot count (the tiny ServeEngine demos used 1.0 at 4 slots)
    fetch_occupancy: float = 0.001
    max_steps: int = 3000

    def __post_init__(self):
        if self.process not in PROCESSES:
            raise ValueError(f"unknown arrival process {self.process!r}; "
                             f"choose from {PROCESSES}")
        if self.rate <= 0:
            raise ValueError("rate must be > 0")
        if self.n_requests < 0:
            raise ValueError("n_requests must be >= 0")
        if not 0.0 <= self.chat_frac <= 1.0:
            raise ValueError("chat_frac must be in [0, 1]")
        if not 0.0 < self.burst_duty < 1.0:
            raise ValueError("burst_duty must be in (0, 1)")
        if self.burst_boost * self.burst_duty > 1.0:
            raise ValueError(
                "burst_boost * burst_duty must be <= 1 (the off-burst "
                "rate would be negative)")
        if not 0.0 <= self.diurnal_amp < 1.0:
            raise ValueError("diurnal_amp must be in [0, 1)")
        if self.max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if self.chat_frac > 0 and self.n_shared_prefixes < 1:
            raise ValueError("chat requests need >= 1 shared prefix")
        longest = max(self.shared_prefix_len + self.chat_prompt[1],
                      self.rag_prompt[1])
        if longest > self.max_len:
            raise ValueError(f"longest prompt ({longest}) exceeds "
                             f"max_len ({self.max_len})")

    def pool_config(self) -> PoolConfig:
        """The PoolConfig this spec's pool runs under (policy preset is
        supplied separately — the experiment's policy axis)."""
        return PoolConfig(
            budget_blocks=self.budget_blocks,
            block_tokens=self.block_tokens,
            sampling_interval=self.sampling_interval,
            fetch_latency=self.fetch_latency,
            fetch_occupancy=self.fetch_occupancy)

    @property
    def n_pseudo_slots(self) -> int:
        """Pseudo-slot rows for shared prefixes — matches ServeEngine's
        ``max_slots + 8`` sizing so parity extends to counter arrays."""
        return max(8, self.n_shared_prefixes)


#: the named serving family: quick 64-slot A/B scenarios (tight budget —
#: the regime where divergence-aware residency pays), plus the
#: traffic-scale 2048-slot Poisson spec (offered load > slot capacity so
#: occupancy saturates at 2048 concurrent in-flight requests)
SERVING_SPECS: Dict[str, ServingSpec] = {
    s.name: s for s in (
        # 64-slot A/B regime: offered load ~0.7 req/step sits between
        # MeDiC's capacity (chat protected, RAG streamed) and LRU's
        # thrash-degraded capacity, and budget 224 covers the chat
        # working set but not chat+RAG — the pollution regime where
        # divergence-aware residency pays. All requests complete within
        # the horizon, so tail latencies are not truncation artifacts.
        ServingSpec("SERVE_POISSON64", process="poisson", rate=0.7,
                    n_requests=192),
        ServingSpec("SERVE_BURSTY64", process="bursty", rate=0.7,
                    n_requests=192, burst_period=96.0, burst_duty=0.25,
                    burst_boost=3.0),
        ServingSpec("SERVE_DIURNAL64", process="diurnal", rate=0.7,
                    n_requests=192, diurnal_period=256.0, diurnal_amp=0.8),
        # traffic scale: offered load (48 req/step x ~70-step service)
        # far exceeds 2048 slots, so occupancy saturates at 2048
        # concurrent in-flight requests — the min decode length (48)
        # exceeds the ~43 steps it takes 2048 arrivals to accumulate, so
        # saturation holds under ANY pool policy; budget is ample
        # (scale, not pressure, is what this spec demonstrates)
        ServingSpec("SERVE_POISSON2K", process="poisson", rate=48.0,
                    n_requests=4096, max_slots=2048, budget_blocks=40960,
                    decode=(48, 96), fetch_occupancy=0.0002,
                    max_steps=1200),
    )
}
