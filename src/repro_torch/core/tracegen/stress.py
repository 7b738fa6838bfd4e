"""Scheduler-stress scenario matrix — warp populations far beyond the
paper's 48, in the spirit of the larger sweeps of WaSP (arXiv:2404.06156)
and Dynamic Warp Resizing (arXiv:1208.2374).

Three stressor families, each isolating one pressure source:

  * HAMMER — queue-hammering: memory-bound intensity with a
    mostly-miss/all-miss-dominated mix, so nearly every instruction
    floods the L2 bank queues and the DRAM low-priority queue (Fig 5's
    tail, at 40-80x the request rate);
  * PHASE — phase-shift-heavy: most warps flip archetype mid-kernel,
    stressing the warp-type classifier's re-learning path (Fig 4's
    long-term-shift caveat made the common case);
  * FRONTIER — shared-pool-dominated graph frontiers: reuse is mostly
    inter-warp (boosted shared fractions, larger pool), so per-warp
    insertion/bypass decisions interact across the whole population.

All specs keep the paper's 64x16 instruction geometry so a trace at
n_warps=4096 stays ~16 MB and the full matrix generates in seconds on
the vectorized sampler (benchmarks/run.py --only tracegen).
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.tracegen.spec import Phase, TraceSpec

_HAMMER_MIX: Tuple[float, ...] = (0.02, 0.08, 0.10, 0.45, 0.35)
_PHASE_MIX: Tuple[float, ...] = (0.10, 0.25, 0.30, 0.25, 0.10)
_FRONTIER_MIX: Tuple[float, ...] = (0.05, 0.25, 0.30, 0.25, 0.15)

STRESS_SPECS: Dict[str, TraceSpec] = {s.name: s for s in [
    TraceSpec("WIDE1K", mix=(0.05, 0.25, 0.10, 0.35, 0.25), intensity=0.95,
              n_warps=1024),
    TraceSpec("HAMMER2K", mix=_HAMMER_MIX, intensity=1.0, n_warps=2048),
    TraceSpec("HAMMER4K", mix=_HAMMER_MIX, intensity=0.98, n_warps=4096),
    TraceSpec("PHASE2K", mix=_PHASE_MIX, intensity=0.80, n_warps=2048,
              phase_shift=True, phase_flip_prob=0.75),
    TraceSpec("FRONTIER2K", mix=_FRONTIER_MIX, intensity=0.95, n_warps=2048,
              shared_boost=6.0, shared_pool_lines=512),
]}

STRESS_NAMES = tuple(STRESS_SPECS)

# ---------------------------------------------------------------------------
# Sharded-sweep stress tier: populations one to two orders beyond the 4k
# ceiling above, in the wide-warp spirit of the Dynamic Warp Resizing
# configs. Kept OUT of ``STRESS_SPECS`` so the default stress matrix is
# unchanged; these sizes are meant for the wavefront engine's sharded-warp
# path on a device mesh (``simulate(..., mesh=, warp_axes=)``,
# ``registry.stress_shard``). Both warp counts are powers of two so every
# 2^k-sized mesh axis divides them. WIDE64K cannot be lowered at 65,536
# warps: ``make_layout`` raises (its address space overflows int32), as
# the reference's does.
# ---------------------------------------------------------------------------

SHARD_STRESS_SPECS: Dict[str, TraceSpec] = {s.name: s for s in [
    TraceSpec("HAMMER16K", mix=_HAMMER_MIX, intensity=1.0, n_warps=16384),
    TraceSpec("WIDE64K", mix=(0.05, 0.25, 0.10, 0.35, 0.25),
              intensity=0.95, n_warps=65536),
]}

SHARD_STRESS_NAMES = tuple(SHARD_STRESS_SPECS)

# ---------------------------------------------------------------------------
# PHASED family: drifting-regime schedules for the online
# warp-reclassification story. Unlike PHASE2K (whose warps flip once at
# the midpoint), these specs swing the whole population's hit-ratio
# structure through distinct regimes — hit-heavy -> mixed -> miss-heavy,
# with working-set churn at the boundaries — so a phase-0 warp-type
# label is WRONG for most of the run and the classifier's
# reclassification window is what decides bypass/insertion/priority
# quality. The PHASED_RECOVER_* mirror family below drifts the other way:
# it is measurable because ``classifier.observe`` measures the window
# ratio over the cache-path ``probed`` sample only, so a reformed warp's
# probe stream can cross the 0.8 mostly-hit threshold (a ratio over all
# accesses would cap a bypassing warp at 1/8 < the 0.2 mostly-miss
# threshold: the probe-ratchet). Sized 48 (differential-testable on the
# event engine) up to 2k warps (wavefront-only scale).
# ---------------------------------------------------------------------------

_HIT_HEAVY = (0.30, 0.45, 0.15, 0.07, 0.03)
_MIXED = (0.10, 0.25, 0.30, 0.25, 0.10)
_MISS_HEAVY = (0.03, 0.07, 0.15, 0.40, 0.35)

#: hit-heavy warm-up, slide to a mixed regime with working-set churn,
#: then a hard swing to miss-heavy at raised memory pressure — the
#: canonical degrading 3-regime drift schedule used at every PHASED_*
#: size
_DRIFT_SCHEDULE = (
    Phase(frac=1.0, mix=_HIT_HEAVY),
    Phase(frac=1.0, mix=_MIXED, churn=0.5),
    Phase(frac=1.0, mix=_MISS_HEAVY, churn=0.5, intensity=0.98),
)


def _phased(name: str, n_warps: int, intensity: float) -> TraceSpec:
    return TraceSpec(name, mix=_MIXED, intensity=intensity,
                     n_warps=n_warps, phases=_DRIFT_SCHEDULE)


PHASED_SPECS: Dict[str, TraceSpec] = {s.name: s for s in [
    _phased("PHASED48", 48, 0.95),
    _phased("PHASED256", 256, 0.95),
    _phased("PHASED1K", 1024, 0.92),
    _phased("PHASED2K", 2048, 0.90),
]}

PHASED_NAMES = tuple(PHASED_SPECS)

#: the mirror drift — miss-heavy warm-up at raised memory pressure,
#: slide back through mixed, then a hit-heavy tail. Phase-0 labels are
#: miss-shaped, so under a bypass policy the classifier must ratchet
#: labels back UP off the probe stream to stop bypassing reformed warps
#: — exactly the direction the probe-ratchet would block. Same 3-regime
#: geometry as ``_DRIFT_SCHEDULE`` so the two directions are comparable
#: like-for-like.
_RECOVER_SCHEDULE = (
    Phase(frac=1.0, mix=_MISS_HEAVY, churn=0.5, intensity=0.98),
    Phase(frac=1.0, mix=_MIXED, churn=0.5),
    Phase(frac=1.0, mix=_HIT_HEAVY),
)


def _phased_recover(name: str, n_warps: int, intensity: float) -> TraceSpec:
    return TraceSpec(name, mix=_MIXED, intensity=intensity,
                     n_warps=n_warps, phases=_RECOVER_SCHEDULE)


PHASED_RECOVER_SPECS: Dict[str, TraceSpec] = {s.name: s for s in [
    _phased_recover("PHASED_RECOVER48", 48, 0.95),
    _phased_recover("PHASED_RECOVER256", 256, 0.95),
    _phased_recover("PHASED_RECOVER1K", 1024, 0.92),
    _phased_recover("PHASED_RECOVER2K", 2048, 0.90),
]}

PHASED_RECOVER_NAMES = tuple(PHASED_RECOVER_SPECS)
