"""TraceSpec: archetype mixtures lowered to per-warp parameter arrays.

The lowering contract (DESIGN.md §"Trace generation"):

  spec  ──lower──►  (AddressLayout, WarpParams)  ──sample──►  lines/pcs

* ``AddressLayout`` partitions the int32 line-address space into three
  DISJOINT regions so the trace invariants are true by construction, at
  any warp count: the shared pool sits in [0, 2^13), warp ``w``'s private
  working set in [(w+1)<<13, (w+2)<<13), and the streaming (always-fresh)
  region above every working set. At the paper's scale (48 warps, 64
  instructions x 16 lanes) the layout constants reduce to the original
  generator's (fresh base 2^22, per-warp fresh stride 2^15).

* ``WarpParams`` holds, per seed and per warp: the archetype of each
  PHASE of the kernel, the lowered per-phase scalars (working-set size,
  reuse probability, shared fraction), the per-phase working-set keys
  and line tables (a keyed 12-bit Feistel permutation — distinct lines
  without replacement), the PC table and the shared pool.
  ``lower_warps`` stops short of the tables, which are the only part
  larger than O(S·W·P): the CUDA sampler (``kernels/tracegen``)
  permutes the one index a cell draws instead.

* The **phase schedule** (DESIGN.md §11). A spec without ``phases`` is
  the legacy model: two identical kernel halves, optionally connected by
  the ``phase_shift`` mid-kernel archetype flip (Fig 4) — lowered with
  exactly the seed-era RNG draws, so legacy traces are byte-identical.
  A spec WITH ``phases`` is a drifting workload: each ``Phase`` entry
  occupies ``frac`` of the instruction stream and may, at its entry
  boundary, redraw warp archetypes from a new ``mix`` (``flip_prob``
  controls what fraction of warps redraw), re-key private working sets
  (``churn`` — cold misses even for stable-type warps), and change
  ``intensity`` (lowered to a per-instruction compute gap). All phase
  draws are counter-RNG draws at (tag, p*W + w), so the loop generator
  (``ref.py``) stays bit-identical to the vectorized sampler, and a single-phase schedule reduces
  byte-identically to the static legacy spec.

Everything downstream of ``lower`` is a pure function of these arrays,
which is what lets ``sampler.py`` materialize all cells at once, and the
CUDA sampler draw each cell in a thread of its own.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core.tracegen import rng

# archetype = (working-set lines, reuse probability, shared-pool fraction)
# — the five warp types of Fig 2, spanning all-hit .. all-miss.
ARCHETYPES = {
    "all_hit": (16, 0.998, 0.0),
    "mostly_hit": (24, 0.96, 0.05),
    "balanced": (64, 0.50, 0.10),
    "mostly_miss": (128, 0.15, 0.10),
    "all_miss": (0, 0.0, 0.0),
}

WS_REGION_BITS = 13                   # 8192-line private region per warp
WS_CHOICE_BITS = 12                   # working set drawn from 4096 offsets
_MIN_FRESH_BASE = 1 << 22
_MIN_FRESH_STRIDE = 1 << 15
_INT32_LIMIT = (1 << 31) - 1


def _npow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _gap_of(intensity: float) -> np.float32:
    return np.float32(4.0 + (1.0 - intensity) * 120.0)


@dataclasses.dataclass(frozen=True)
class Phase:
    """One entry of a ``TraceSpec.phases`` schedule.

    frac:      relative length weight (normalized over the schedule and
               lowered to instruction boundaries);
    mix:       archetype mixture warps redraw from at phase entry
               (None: redraws — if any — use the spec's base mix);
    flip_prob: fraction of warps that redraw at phase entry; default is
               1.0 when ``mix`` is given (a real regime change) and 0.0
               otherwise (pure continuation). Ignored for phase 0, which
               always draws.
    churn:     probability a warp re-keys its private working set at
               phase entry (cold working-set misses). Ignored for
               phase 0 (its working set is always freshly keyed).
    intensity: per-phase intensity override (None: spec.intensity);
               lowered to a per-instruction compute gap.
    """
    frac: float = 1.0
    mix: Optional[Tuple[float, ...]] = None
    flip_prob: Optional[float] = None
    churn: float = 0.0
    intensity: Optional[float] = None

    def __post_init__(self):
        if self.mix is not None:
            object.__setattr__(self, "mix", tuple(float(m) for m in self.mix))


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Workload-agnostic trace description. ``mix`` gives the fraction of
    warps drawn from each archetype (same order as ``archetypes``)."""
    name: str
    mix: Tuple[float, ...]
    intensity: float                   # 1 = memory bound (tiny compute gap)
    n_warps: int = 48
    n_instr: int = 64
    lines_per_instr: int = 16
    n_pcs: int = 12
    phase_shift: bool = False          # mid-kernel archetype change
    phase_flip_prob: float = 0.25
    shared_pool_lines: int = 256
    shared_boost: float = 1.0          # multiplier on archetype shared fracs
    archetypes: Optional[Tuple[Tuple[int, float, float], ...]] = None
    phases: Optional[Tuple[Phase, ...]] = None   # drifting-regime schedule

    @classmethod
    def from_workload(cls, wl) -> "TraceSpec":
        """Lift a legacy ``workloads.WorkloadSpec`` (duck-typed)."""
        return cls(name=wl.name, mix=tuple(wl.mix), intensity=wl.intensity,
                   n_warps=wl.n_warps, n_instr=wl.n_instr,
                   lines_per_instr=wl.lines_per_instr, n_pcs=wl.n_pcs,
                   phase_shift=wl.phase_shift)

    def archetype_table(self) -> np.ndarray:
        """f64[A, 3] rows of (ws_lines, reuse_p, shared_frac)."""
        rows = self.archetypes or tuple(ARCHETYPES.values())
        tab = np.asarray(rows, np.float64)
        tab[:, 2] = np.clip(tab[:, 2] * self.shared_boost, 0.0, 1.0)
        return tab

    @property
    def compute_gap(self) -> np.float32:
        return _gap_of(self.intensity)


def trace_key(spec_name: str, seed: int) -> int:
    """Root key of one (workload, seed) trace — the same convention the
    original generator used for its ``default_rng`` seed."""
    return rng.mix64_scalar(
        (int(seed) + (zlib.crc32(spec_name.encode()) << 32))
        & ((1 << 64) - 1))


@dataclasses.dataclass(frozen=True)
class AddressLayout:
    """Disjoint int32 address regions; all fields are line addresses."""
    n_warps: int
    pool_region: int                   # shared pool ⊂ [0, pool_region)
    fresh_base: int                    # streaming region starts here
    fresh_stride: int                  # per-warp streaming sub-region

    def ws_base(self, w) -> np.ndarray:
        return (np.asarray(w, np.int64) + 1) << WS_REGION_BITS

    def fresh_addr(self, w, slot) -> np.ndarray:
        """Streaming address of flat slot (ii*L + li) of warp w. Slots are
        consumed positionally, so a cell's address never depends on how
        many earlier draws chose the streaming branch."""
        return (self.fresh_base
                + np.asarray(w, np.int64) * self.fresh_stride
                + np.asarray(slot, np.int64))


def _validate_phases(spec: TraceSpec) -> None:
    n_arch = len(spec.archetypes or ARCHETYPES)
    if spec.phase_shift:
        raise ValueError(
            f"{spec.name}: phases= and phase_shift=True are mutually "
            "exclusive — the legacy mid-kernel flip IS a two-phase "
            "schedule; express it as phases instead")
    if not spec.phases:
        raise ValueError(f"{spec.name}: phases must be a non-empty tuple")
    total = 0.0
    for i, ph in enumerate(spec.phases):
        if not isinstance(ph, Phase):
            raise ValueError(f"{spec.name}: phases[{i}] is not a Phase")
        if not np.isfinite(ph.frac) or ph.frac < 0:
            raise ValueError(f"{spec.name}: phases[{i}].frac must be >= 0")
        total += float(ph.frac)
        if ph.mix is not None:
            if len(ph.mix) != n_arch:
                raise ValueError(
                    f"{spec.name}: phases[{i}].mix has {len(ph.mix)} "
                    f"entries, archetype table has {n_arch}")
            s = float(np.sum(np.asarray(ph.mix, np.float64)))
            if abs(s - 1.0) > 1e-9:
                raise ValueError(
                    f"{spec.name}: phases[{i}].mix sums to {s}, not 1")
        if ph.flip_prob is not None and not 0.0 <= ph.flip_prob <= 1.0:
            raise ValueError(
                f"{spec.name}: phases[{i}].flip_prob outside [0, 1]")
        if not 0.0 <= ph.churn <= 1.0:
            raise ValueError(f"{spec.name}: phases[{i}].churn outside [0, 1]")
        if ph.intensity is not None and not 0.0 <= ph.intensity <= 1.0:
            raise ValueError(
                f"{spec.name}: phases[{i}].intensity outside [0, 1]")
    if total <= 0:
        raise ValueError(f"{spec.name}: phase fracs sum to 0")


def make_layout(spec: TraceSpec) -> AddressLayout:
    # spec validation lives here because both the sampler and the loop
    # reference lower through make_layout first
    mix_sum = float(np.sum(np.asarray(spec.mix, np.float64)))
    if abs(mix_sum - 1.0) > 1e-9:
        raise ValueError(f"{spec.name}: mix sums to {mix_sum}, not 1")
    if spec.phases is not None:
        _validate_phases(spec)
    tab = spec.archetype_table()
    if tab[:, 0].max() > (1 << WS_CHOICE_BITS):
        raise ValueError(
            f"{spec.name}: working-set size {int(tab[:, 0].max())} exceeds "
            f"the {1 << WS_CHOICE_BITS}-line per-warp choice domain "
            f"(perm12 is only a bijection on [0, 4096))")
    ws_top = (spec.n_warps + 1) << WS_REGION_BITS
    fresh_base = max(_MIN_FRESH_BASE, _npow2(ws_top))
    fresh_stride = max(_MIN_FRESH_STRIDE,
                       _npow2(spec.n_instr * spec.lines_per_instr))
    top = fresh_base + spec.n_warps * fresh_stride
    if top > _INT32_LIMIT:
        raise ValueError(
            f"{spec.name}: address space overflows int32 "
            f"(n_warps={spec.n_warps}, top={top}); shrink the scenario")
    return AddressLayout(spec.n_warps, 1 << WS_REGION_BITS,
                         fresh_base, fresh_stride)


# ---------------------------------------------------------------------------
# phase-schedule compilation (shared by sampler.py and ref.py)
# ---------------------------------------------------------------------------

class PhasePlan(NamedTuple):
    """One lowered phase: everything the RNG draws need.

    ``legacy`` marks the seed-era second kernel half, whose flip draws
    stay at index w (TAG_PHASE / uniform TAG_PHASE_PICK) for bytewise
    compatibility; scheduled phases draw at index p*W + w instead.
    """
    cum: np.ndarray          # f64[A] inverse-CDF table for redraws
    flip_prob: float         # fraction of warps redrawing at entry
    churn: float             # fraction of warps re-keying working sets
    gap: np.float32          # compute gap while this phase runs
    legacy: bool


def compile_schedule(spec: TraceSpec
                     ) -> Tuple[np.ndarray, Tuple[PhasePlan, ...]]:
    """Lower the spec's schedule to (bounds i64[P+1], per-phase plans).

    ``bounds[p] .. bounds[p+1]`` is phase p's instruction range. A spec
    without ``phases`` compiles to the legacy two-half schedule (identical
    halves unless ``phase_shift``); zero-length phases (after rounding
    fracs to instruction boundaries) are legal — their entry draws still
    happen, so archetype/working-set chains stay well-defined.
    """
    base_cum = np.cumsum(np.asarray(spec.mix, np.float64))
    if spec.phases is None:
        flip = float(spec.phase_flip_prob) if spec.phase_shift else 0.0
        gap = _gap_of(spec.intensity)
        bounds = np.asarray([0, spec.n_instr // 2, spec.n_instr], np.int64)
        return bounds, (PhasePlan(base_cum, 1.0, 1.0, gap, False),
                        PhasePlan(base_cum, flip, 0.0, gap, True))
    _validate_phases(spec)
    fracs = np.asarray([p.frac for p in spec.phases], np.float64)
    cumfrac = np.cumsum(fracs) / fracs.sum()
    bounds = np.concatenate([
        [0], np.round(cumfrac * spec.n_instr).astype(np.int64)])
    bounds = np.maximum.accumulate(bounds)
    bounds[-1] = spec.n_instr
    plans = []
    for p, ph in enumerate(spec.phases):
        cum = np.cumsum(np.asarray(ph.mix, np.float64)) \
            if ph.mix is not None else base_cum
        flip = ph.flip_prob if ph.flip_prob is not None \
            else (1.0 if ph.mix is not None else 0.0)
        gap = _gap_of(spec.intensity if ph.intensity is None
                      else ph.intensity)
        plans.append(PhasePlan(cum, float(flip), float(ph.churn), gap,
                               False))
    return bounds, tuple(plans)


def phase_of_instr(spec: TraceSpec) -> np.ndarray:
    """i64[I]: which phase each instruction belongs to."""
    bounds, _ = compile_schedule(spec)
    return np.searchsorted(bounds[1:-1], np.arange(spec.n_instr),
                           side="right").astype(np.int64)


def lowered_gap(spec: TraceSpec):
    """Per-instruction compute gap: a f32 scalar when the whole schedule
    runs at one intensity (the legacy contract — and what keeps a
    single-phase spec byte-identical to its static form), else f32[I]."""
    bounds, plans = compile_schedule(spec)
    gaps = np.asarray([pl.gap for pl in plans], np.float32)
    if np.all(gaps == gaps[0]):
        return gaps[0]
    return gaps[phase_of_instr(spec)]


@dataclasses.dataclass(frozen=True)
class WarpParams:
    """Per-(seed, warp, phase) lowered parameters. Leading axis
    S = len(seeds); P = number of schedule phases (2 for legacy specs)."""
    arch: np.ndarray         # i64[S, W, P] archetype per phase
    ws_size: np.ndarray      # i64[S, W, P] working-set lines per phase
    reuse: np.ndarray        # f64[S, W, P] reuse probability per phase
    shared: np.ndarray       # f64[S, W, P] shared fraction per phase
    ws_table: Optional[np.ndarray]  # i64[S, W, P, max_ws] working-set
                                    # line addrs (None from lower_warps)
    pc_table: np.ndarray     # i32[S, W, n_pcs]
    pool: np.ndarray         # i64[S, shared_pool_lines] shared-pool addrs
    ws_key: np.ndarray       # u64[S, W, P] working-set permutation keys

    @property
    def n_phases(self) -> int:
        return self.arch.shape[-1]


def _inv_cdf(cum: np.ndarray, u: np.ndarray) -> np.ndarray:
    return np.minimum(np.searchsorted(cum, u, side="right"),
                      len(cum) - 1).astype(np.int64)


def lower_warps(spec: TraceSpec,
                seeds) -> Tuple[AddressLayout, WarpParams]:
    """Lower the schedule to per-(warp, phase) parameter arrays for every
    seed in ``seeds`` at once (vectorized; the loop generator in ref.py
    recomputes the same values scalar-wise): O(S·W·P) work, everything
    but the working-set tables (``ws_table`` is None), which a cell reads
    at one index as ``ws_base(w) + perm12(j, ws_key)``."""
    seeds = np.atleast_1d(np.asarray(seeds, np.int64))
    layout = make_layout(spec)
    tab = spec.archetype_table()
    n_arch = tab.shape[0]
    w_n = spec.n_warps
    w_idx = np.arange(w_n, dtype=np.uint64)[None, :]              # [1, W]
    roots = np.asarray([trace_key(spec.name, int(s)) for s in seeds],
                       np.uint64)[:, None]                        # [S, 1]
    _, plans = compile_schedule(spec)

    # phase 0: archetype via inverse CDF; freshly keyed working set —
    # exactly the legacy per-warp draws
    arch_p = [_inv_cdf(plans[0].cum,
                       rng.uniform(rng.stream_key(roots, rng.TAG_ARCH),
                                   w_idx))]
    key_p = [rng.bits(rng.stream_key(roots, rng.TAG_WS), w_idx)]  # [S, W]

    for p, plan in enumerate(plans[1:], start=1):
        if plan.legacy:
            flip = rng.uniform(rng.stream_key(roots, rng.TAG_PHASE),
                               w_idx) < plan.flip_prob
            pick = rng.randint(rng.stream_key(roots, rng.TAG_PHASE_PICK),
                               w_idx, n_arch)
            arch_p.append(np.where(flip, pick, arch_p[-1]))
            key_p.append(key_p[-1])                # legacy never re-keys
            continue
        pidx = np.uint64(p) * np.uint64(w_n) + w_idx
        flip = rng.uniform(rng.stream_key(roots, rng.TAG_PHASE),
                           pidx) < plan.flip_prob
        pick = _inv_cdf(plan.cum,
                        rng.uniform(rng.stream_key(roots, rng.TAG_PHASE_MIX),
                                    pidx))
        arch_p.append(np.where(flip, pick, arch_p[-1]))
        rekey = rng.uniform(rng.stream_key(roots, rng.TAG_WS_CHURN),
                            pidx) < plan.churn
        key_p.append(np.where(
            rekey, rng.bits(rng.stream_key(roots, rng.TAG_WS_KEY), pidx),
            key_p[-1]))

    arch = np.stack(arch_p, axis=-1)                              # [S, W, P]
    wkeys = np.stack(key_p, axis=-1)                              # [S, W, P]
    ws_size = tab[arch, 0].astype(np.int64)
    reuse = tab[arch, 1]
    shared = tab[arch, 2]

    pc_flat = w_idx[:, :, None] * np.uint64(spec.n_pcs) \
        + np.arange(spec.n_pcs, dtype=np.uint64)[None, None, :]
    pc_table = rng.randint(rng.stream_key(roots[:, :, None], rng.TAG_PC),
                           pc_flat, 1 << 16).astype(np.int32)

    p_idx = np.arange(spec.shared_pool_lines, dtype=np.uint64)[None, :]
    pool = rng.randint(rng.stream_key(roots, rng.TAG_POOL), p_idx,
                       layout.pool_region)

    return layout, WarpParams(arch, ws_size, reuse, shared, None,
                              pc_table, pool, wkeys)


def working_sets(spec: TraceSpec, layout: AddressLayout,
                 ws_key: np.ndarray) -> np.ndarray:
    """i64[S, W, P, max_ws]: every warp's working-set lines in each phase,
    a keyed Feistel permutation (distinct lines) of its private region."""
    max_ws = max(int(spec.archetype_table()[:, 0].max()), 1)
    j = np.arange(max_ws, dtype=np.uint64)[None, None, None, :]
    return layout.ws_base(np.arange(spec.n_warps))[None, :, None, None] \
        + rng.perm12(j, ws_key[:, :, :, None])


def lower(spec: TraceSpec, seeds) -> Tuple[AddressLayout, WarpParams]:
    """``lower_warps`` with the working-set tables built: what the numpy
    sampler gathers from."""
    layout, wp = lower_warps(spec, seeds)
    return layout, dataclasses.replace(
        wp, ws_table=working_sets(spec, layout, wp.ws_key))
