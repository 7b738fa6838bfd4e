"""Scenario: a named, hashable description of one simulated situation
(the port of ``repro.api.scenario``).

A scenario is everything needed to materialize traces — a ``TraceSpec``
(one of the paper's 15 workloads, a stress-matrix or phased spec, or a
hand-built spec) or a ``ServingSpec`` (an open-loop serving scenario),
the trace seeds, and an optional warp-count override —
plus the label under which its results appear in a ``ResultSet``.

Scenarios are immutable and hashable, so they can key caches and be
deduplicated by the plan compiler. Lowering to concrete trace arrays
goes through ``repro_torch.core.tracegen`` (the counter-RNG samplers,
bit-exact with the reference's). ``materialize()`` draws the cells on
the host, in numpy; ``materialize(device)`` draws them where the
simulations will run: on a CUDA device with the CUDA sampler
(``repro_torch.kernels.tracegen``: the host lowers the warps, the kernel
writes the cells into device memory), on the CPU with the numpy sampler.
A serving scenario lowers to request streams through
``repro_torch.serving.sim``'s counter-RNG arrival processes, on the
host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.core import tracegen as TG
from repro_torch.core import workloads as WL
from repro_torch.kernels.tracegen import ops as KTG
from repro_torch.serving.sim.arrivals import generate_serving
from repro_torch.serving.sim.spec import SERVING_SPECS, ServingSpec

Shape = Tuple[int, int, int]          # (n_instr, n_warps, lines_per_instr)
                                      # serving: (-1, max_slots, n_requests)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named simulation situation: spec × seeds (× warp override).

    ``name`` labels results; it defaults to the spec's name via the
    constructors below. ``n_warps`` overrides the spec's warp count
    (the trace RNG stays keyed on the spec name, matching the
    ``dataclasses.replace(spec, n_warps=...)`` scaling idiom).
    """
    name: str
    spec: Union[TG.TraceSpec, ServingSpec]
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
        if self.is_serving and self.n_warps is not None:
            raise ValueError(f"scenario {self.name!r}: n_warps does not "
                             "apply to serving scenarios")

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
    def serving(cls, scenario: Union[str, ServingSpec], seeds=(0,),
                name: Optional[str] = None) -> "Scenario":
        """An open-loop serving scenario (``serving.sim``): a name from
        ``SERVING_SPECS`` or a hand-built ``ServingSpec``. Runs on the
        serving simulator (``Experiment(engine="serving")``); request
        streams lower through the counter-RNG arrival processes."""
        if isinstance(scenario, ServingSpec):
            spec = scenario
        elif scenario in SERVING_SPECS:
            spec = SERVING_SPECS[scenario]
        else:
            raise ValueError(f"unknown serving scenario {scenario!r}; "
                             f"choose from {tuple(SERVING_SPECS)} or pass "
                             "a ServingSpec")
        return cls(name or spec.name, spec, tuple(seeds), None)

    @property
    def is_serving(self) -> bool:
        return isinstance(self.spec, ServingSpec)

    # -- lowering -----------------------------------------------------------

    @property
    def trace_spec(self) -> TG.TraceSpec:
        """The spec with the warp-count override applied."""
        if self.is_serving:
            raise TypeError(f"scenario {self.name!r} is a serving "
                            "scenario; it has no trace spec")
        if self.n_warps is None or self.n_warps == self.spec.n_warps:
            return self.spec
        return dataclasses.replace(self.spec, n_warps=self.n_warps)

    @property
    def shape(self) -> Shape:
        if self.is_serving:
            return (-1, self.spec.max_slots, self.spec.n_requests)
        s = self.trace_spec
        return (s.n_instr, s.n_warps, s.lines_per_instr)

    @property
    def n_seeds(self) -> int:
        return len(self.seeds)

    def materialize(self, device=None) -> Dict[str, Any]:
        """Concrete trace arrays, seed-stacked along the leading axis:
        lines i32[S, I, W, L], pcs i32[S, I, W], compute_gap f32[S]
        (f32[S, I] when the phase schedule varies intensity),
        archetype i32[S, W] (+ archetype2), oracle_wtype i32[S, I, W].

        Without ``device`` every array is numpy, sampled on the host.
        With one, ``lines``, ``pcs`` and ``oracle_wtype`` are tensors on
        it: drawn there by the CUDA sampler on a CUDA device, by the
        numpy sampler on the CPU (``kernels.tracegen.ops.sample_cells``),
        the same bits either way; the rest stay numpy.

        Serving scenarios instead lower to seed-stacked request streams:
        arrival f64[S, n], prompt_len/decode_len/prefix_id/prefix_len
        i64[S, n] (``serving.sim.arrivals.generate_serving``)."""
        if self.is_serving:
            per_seed = [generate_serving(self.spec, s) for s in self.seeds]
            return {k: np.stack([p[k] for p in per_seed])
                    for k in per_seed[0]}
        if device is None:
            tr = TG.generate_batch([self.trace_spec], self.seeds)
            return {k: v[0] for k, v in tr.items()}
        spec = self.trace_spec
        tr = KTG.sample_cells(spec, self.seeds, device)
        tr.pop("archetype_phases")
        gap = np.asarray(TG.lowered_gap(spec), np.float32)
        tr["compute_gap"] = np.broadcast_to(
            gap, (self.n_seeds, *gap.shape)).copy()
        return tr
