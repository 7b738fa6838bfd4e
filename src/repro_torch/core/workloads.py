"""Synthetic GPGPU workload traces mirroring the paper's 15 applications
(the port's copy of ``repro.core.workloads``).

Each application is an address-stream generator whose measured
characteristics match what the paper reports for its app class:
inter-warp hit-ratio heterogeneity (Fig 2), temporal stability (Fig 4)
and L2 pressure through ``intensity`` (Fig 5). The generator fixes only
the ADDRESS STREAM — whether a request hits is decided by the simulated
cache under the policy being evaluated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.core import tracegen
from repro_torch.core.tracegen import ARCHETYPES  # noqa: F401  (re-export)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    suite: str
    # fraction of warps drawn from each archetype (sums to 1)
    mix: Tuple[float, float, float, float, float]  # allhit..allmiss order
    intensity: float          # 1 = memory bound (tiny compute gap)
    n_warps: int = 48
    n_instr: int = 64
    lines_per_instr: int = 16
    n_pcs: int = 12
    phase_shift: bool = False  # mid-kernel archetype change for some warps


# 15 applications, 4 suites — mixes chosen to span the paper's behaviours:
# graph workloads (Lonestar) are bimodal & memory-intensive, MARS map-reduce
# apps have large mostly-hit populations, Rodinia stencils are balanced,
# SDK kernels are streaming-heavy.
WORKLOADS: Dict[str, WorkloadSpec] = {s.name: s for s in [
    WorkloadSpec("BFS", "lonestar", (0.05, 0.25, 0.10, 0.35, 0.25), 0.95),
    WorkloadSpec("SSSP", "lonestar", (0.05, 0.25, 0.10, 0.30, 0.30), 0.95),
    WorkloadSpec("MST", "lonestar", (0.05, 0.20, 0.15, 0.35, 0.25), 0.85),
    WorkloadSpec("BH", "lonestar", (0.15, 0.35, 0.20, 0.20, 0.10), 0.70),
    WorkloadSpec("DMR", "lonestar", (0.05, 0.15, 0.30, 0.30, 0.20), 0.75),
    WorkloadSpec("PVC", "mars", (0.10, 0.45, 0.15, 0.20, 0.10), 0.80),
    WorkloadSpec("PVR", "mars", (0.10, 0.40, 0.20, 0.20, 0.10), 0.80),
    WorkloadSpec("SS", "mars", (0.15, 0.40, 0.15, 0.20, 0.10), 0.75),
    WorkloadSpec("IIX", "mars", (0.05, 0.30, 0.25, 0.25, 0.15), 0.85),
    WorkloadSpec("BP", "rodinia", (0.10, 0.30, 0.30, 0.20, 0.10), 0.60),
    WorkloadSpec("HS", "rodinia", (0.10, 0.25, 0.35, 0.20, 0.10), 0.55),
    WorkloadSpec("NW", "rodinia", (0.05, 0.20, 0.35, 0.25, 0.15), 0.65),
    WorkloadSpec("SRAD", "rodinia", (0.05, 0.25, 0.30, 0.25, 0.15), 0.70,
                 phase_shift=True),
    WorkloadSpec("CONS", "sdk", (0.02, 0.13, 0.20, 0.30, 0.35), 0.90),
    WorkloadSpec("SCP", "sdk", (0.02, 0.18, 0.25, 0.25, 0.30), 0.85),
]}

WORKLOAD_NAMES = tuple(WORKLOADS)


def generate(spec: WorkloadSpec, seed: int = 0):
    """Build the trace. Returns dict of numpy arrays:
      lines: i32[I, W, L]   cache-line addresses (-1 = inactive lane)
      pcs:   i32[I, W]      instruction PC ids
      compute_gap: f32      cycles between a warp's instructions
      archetype: i32[W]     ground-truth archetype per warp (for Fig 2/4)
    """
    return tracegen.generate(tracegen.TraceSpec.from_workload(spec), seed)


def generate_suite(workloads=WORKLOAD_NAMES, seeds=(0,)):
    """Stacked traces for several workloads × seeds (same shape required)
    — see ``tracegen.generate_batch`` for the output layout."""
    specs = [tracegen.TraceSpec.from_workload(WORKLOADS[w])
             for w in workloads]
    return tracegen.generate_batch(specs, seeds)
