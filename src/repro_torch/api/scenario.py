"""Scenario: a named, hashable description of one simulated situation
(the port of ``repro.api.scenario``).

A scenario is everything needed to materialize traces — a ``TraceSpec``
(one of the paper's 15 workloads, a stress-matrix or phased spec, or a
hand-built spec), the trace seeds, and an optional warp-count override —
plus the label under which its results appear in a ``ResultSet``.

Scenarios are immutable and hashable, so they can key caches and be
deduplicated by the plan compiler. Lowering to concrete trace arrays
goes through ``repro_torch.core.tracegen`` (the counter-RNG vectorized
sampler, bit-exact with the reference's), on the host, in numpy.

Serving scenarios (``Scenario.serving``) wait for the port of the
open-loop serving simulator (ROADMAP A7) and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import tracegen as TG
from repro_torch.core import workloads as WL

Shape = Tuple[int, int, int]          # (n_instr, n_warps, lines_per_instr)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named simulation situation: spec × seeds (× warp override).

    ``name`` labels results; it defaults to the spec's name via the
    constructors below. ``n_warps`` overrides the spec's warp count
    (the trace RNG stays keyed on the spec name, matching the
    ``dataclasses.replace(spec, n_warps=...)`` scaling idiom).
    """
    name: str
    spec: TG.TraceSpec
    seeds: Tuple[int, ...] = (0,)
    n_warps: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "seeds",
                           tuple(int(s) for s in self.seeds))
        if not self.seeds:
            raise ValueError(f"scenario {self.name!r}: needs >= 1 seed")
        if len(set(self.seeds)) != len(self.seeds):
            raise ValueError(f"scenario {self.name!r}: duplicate seeds in "
                             f"{self.seeds} — result labels would collide")
        if self.n_warps is not None and self.n_warps < 1:
            raise ValueError(
                f"scenario {self.name!r}: n_warps must be >= 1")

    # -- constructors -------------------------------------------------------

    @classmethod
    def workload(cls, workload: str, seeds=(0,),
                 n_warps: Optional[int] = None,
                 name: Optional[str] = None) -> "Scenario":
        """One of the paper's 15 workloads (``workloads.WORKLOADS``)."""
        if workload not in WL.WORKLOADS:
            raise ValueError(f"unknown workload {workload!r}; choose from "
                             f"{WL.WORKLOAD_NAMES}")
        spec = TG.TraceSpec.from_workload(WL.WORKLOADS[workload])
        return cls(name or workload, spec, tuple(seeds), n_warps)

    @classmethod
    def stress(cls, scenario: str, seeds=(0,),
               n_warps: Optional[int] = None,
               name: Optional[str] = None) -> "Scenario":
        """One of the stress-matrix specs: the 1k–4k-warp tier
        (``STRESS_SPECS``) or the 16k–64k tier (``SHARD_STRESS_SPECS``)."""
        known = {**TG.STRESS_SPECS, **TG.SHARD_STRESS_SPECS}
        if scenario not in known:
            raise ValueError(f"unknown stress scenario {scenario!r}; choose "
                             f"from {tuple(known)}")
        return cls(name or scenario, known[scenario],
                   tuple(seeds), n_warps)

    @classmethod
    def phased(cls, scenario: str, seeds=(0,),
               n_warps: Optional[int] = None,
               name: Optional[str] = None) -> "Scenario":
        """One of the drifting-regime phase-schedule specs (48–2k
        warps): the degrading ``PHASED_*`` family (hit -> mixed -> miss)
        and the recovery-shaped ``PHASED_RECOVER_*`` mirror."""
        known = {**TG.PHASED_SPECS, **TG.PHASED_RECOVER_SPECS}
        if scenario not in known:
            raise ValueError(f"unknown phased scenario {scenario!r}; "
                             f"choose from {tuple(known)}")
        return cls(name or scenario, known[scenario],
                   tuple(seeds), n_warps)

    @classmethod
    def from_spec(cls, spec: TG.TraceSpec, seeds=(0,),
                  n_warps: Optional[int] = None,
                  name: Optional[str] = None) -> "Scenario":
        """A hand-built ``TraceSpec`` (custom mixes, boosts, geometries)."""
        return cls(name or spec.name, spec, tuple(seeds), n_warps)

    @classmethod
    def serving(cls, *args, **kwargs) -> "Scenario":
        """Open-loop serving scenarios run on the serving simulator, which
        the port does not have yet."""
        raise ValueError(
            "Scenario.serving: the open-loop serving simulator "
            "(serving/sim) is not ported to repro_torch yet (ROADMAP A7)")

    @property
    def is_serving(self) -> bool:
        return False

    # -- lowering -----------------------------------------------------------

    @property
    def trace_spec(self) -> TG.TraceSpec:
        """The spec with the warp-count override applied."""
        if self.n_warps is None or self.n_warps == self.spec.n_warps:
            return self.spec
        return dataclasses.replace(self.spec, n_warps=self.n_warps)

    @property
    def shape(self) -> Shape:
        s = self.trace_spec
        return (s.n_instr, s.n_warps, s.lines_per_instr)

    @property
    def n_seeds(self) -> int:
        return len(self.seeds)

    def materialize(self) -> Dict[str, np.ndarray]:
        """Concrete trace arrays, seed-stacked along the leading axis:
        lines i32[S, I, W, L], pcs i32[S, I, W], compute_gap f32[S]
        (f32[S, I] when the phase schedule varies intensity),
        archetype i32[S, W] (+ archetype2), oracle_wtype i32[S, I, W]."""
        tr = TG.generate_batch([self.trace_spec], self.seeds)
        return {k: v[0] for k, v in tr.items()}
