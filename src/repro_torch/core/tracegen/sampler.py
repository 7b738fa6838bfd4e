"""Pure-numpy batched trace sampler (copied from
``repro.core.tracegen.sampler``; tests/test_torch_tracegen.py holds it
bit-exact against the reference).

Materializes ``lines``/``pcs`` for every (instruction, warp, lane) cell —
and every seed — in one set of array ops. Each cell's branch structure
mirrors the original loop generator:

    u < reuse?   ──no──►  streaming address (positional fresh slot)
        │yes
    u2 < shared? ──no──►  private working-set line
        │yes
        └──────────────►  shared-pool line

but every uniform/index is a counter-RNG draw addressed by the cell's
flat index, so the result is independent of evaluation order and
bit-identical to the loop generator ``ref.generate_ref``. Phase
schedules only change WHICH per-phase parameters (archetype scalars,
working-set table) a cell gathers — the cell draws themselves are
phase-agnostic, which is why a single-phase schedule reduces
byte-identically to the legacy static spec.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.core import warp_types as WT
from repro_torch.core.tracegen import rng
from repro_torch.core.tracegen.spec import (TraceSpec, WarpParams, lower,
                                            lowered_gap, phase_of_instr,
                                            trace_key)

#: cells (instruction × warp × lane, every seed) sampled in this process,
#: by path: ``"host"`` by the numpy sampler here, ``"device"`` by the CUDA
#: sampler (``repro_torch.kernels.tracegen``); a run reads from it which
#: path its sweeps took
CELLS: Dict[str, int] = {"device": 0, "host": 0}

#: the stream tags of a cell's four draws, in the order ``cell_keys``
#: gives their keys: reuse uniform, shared uniform, pool index, working-set
#: index
CELL_TAGS = (rng.TAG_REUSE_U, rng.TAG_SHARED_U, rng.TAG_SHARED_IDX,
             rng.TAG_WS_IDX)


def cell_keys(spec: TraceSpec, seeds) -> np.ndarray:
    """u64[S, 4]: each seed's stream keys of the ``CELL_TAGS`` draws."""
    roots = np.asarray([trace_key(spec.name, int(s)) for s in seeds],
                       np.uint64)
    return np.stack([rng.stream_key(roots, t) for t in CELL_TAGS], -1)


def warp_outputs(wp: WarpParams) -> Dict[str, np.ndarray]:
    """The per-warp outputs: phase-0 and last-phase archetypes [S, W] and
    the full per-phase matrix [S, W, P]."""
    return {"archetype": wp.arch[:, :, 0].astype(np.int32),
            "archetype2": wp.arch[:, :, -1].astype(np.int32),
            "archetype_phases": wp.arch.astype(np.int32)}


def _sample_cells(spec: TraceSpec, seeds) -> Dict[str, np.ndarray]:
    """All cells for all seeds: lines i32[S, I, W, L], pcs i32[S, I, W]."""
    seeds = np.atleast_1d(np.asarray(seeds, np.int64))
    n_seeds = len(seeds)
    i_n, w_n, l_n = spec.n_instr, spec.n_warps, spec.lines_per_instr
    layout, wp = lower(spec, seeds)
    CELLS["host"] += n_seeds * i_n * w_n * l_n
    phase_of = phase_of_instr(spec)                               # i64[I]

    k_reuse, k_shared, k_pool, k_ws = (
        k.reshape(-1, 1, 1, 1) for k in cell_keys(spec, seeds).T)  # [S,1,1,1]
    ii = np.arange(i_n, dtype=np.int64)[:, None, None]            # [I,1,1]
    wi = np.arange(w_n, dtype=np.int64)[None, :, None]            # [1,W,1]
    li = np.arange(l_n, dtype=np.int64)[None, None, :]            # [1,1,L]
    flat = ((ii * w_n + wi) * l_n + li).astype(np.uint64)[None]   # [1,I,W,L]

    # per-phase archetype scalars, gathered to [S, I, W, 1]
    sg = np.arange(n_seeds)[:, None, None, None]                  # [S,1,1,1]
    pg = phase_of[None, :, None, None]                            # [1,I,1,1]
    wg = np.arange(w_n)[None, None, :, None]                      # [1,1,W,1]
    ws_size_t = wp.ws_size[sg, wg, pg]                            # [S,I,W,1]
    reuse_t = wp.reuse[sg, wg, pg]
    shared_t = wp.shared[sg, wg, pg]

    u = rng.uniform(k_reuse, flat)
    reuse_hit = (ws_size_t > 0) & (u < reuse_t)
    u2 = rng.uniform(k_shared, flat)
    use_shared = reuse_hit & (shared_t > 0) & (u2 < shared_t)

    pool_idx = rng.randint(k_pool, flat, spec.shared_pool_lines)
    shared_line = wp.pool[sg, pool_idx]                           # [S,I,W,L]

    ws_idx = rng.randint(k_ws, flat, np.maximum(ws_size_t, 1))
    ws_line = wp.ws_table[sg, wg, pg, ws_idx]                     # [S,I,W,L]

    fresh_line = layout.fresh_addr(wi[None], ii[None] * l_n + li[None])

    lines = np.where(use_shared, shared_line,
                     np.where(reuse_hit, ws_line, fresh_line))

    pcs = wp.pc_table[np.arange(n_seeds)[:, None, None],
                      np.arange(w_n)[None, None, :],
                      (np.arange(i_n) % spec.n_pcs)[None, :, None]]
    # per-phase ground-truth labels, expanded to [S, I, W] for the
    # engines' oracle labeling mode
    wt_phase = WT.oracle_type_np(wp.reuse, wp.ws_size)            # [S,W,P]
    oracle = wt_phase[np.arange(n_seeds)[:, None, None],
                      np.arange(w_n)[None, None, :],
                      phase_of[None, :, None]]                    # [S,I,W]
    return {
        "lines": lines.astype(np.int32),
        "pcs": pcs.astype(np.int32),
        "oracle_wtype": oracle.astype(np.int32),
        **warp_outputs(wp),
    }


def generate(spec: TraceSpec, seed: int = 0) -> Dict[str, np.ndarray]:
    """One (spec, seed) trace with the original ``workloads.generate``
    output contract: lines i32[I, W, L], pcs i32[I, W], compute_gap f32
    (a scalar — or f32[I] when the phase schedule varies intensity),
    archetype i32[W] (+ archetype2 for the stability tests), plus
    oracle_wtype i32[I, W] (ground-truth per-phase labels) and
    archetype_phases i32[W, P] (the full per-phase archetype matrix)."""
    out = _sample_cells(spec, [seed])
    return {
        "lines": out["lines"][0],
        "pcs": out["pcs"][0],
        "compute_gap": lowered_gap(spec),
        "archetype": out["archetype"][0],
        "archetype2": out["archetype2"][0],
        "oracle_wtype": out["oracle_wtype"][0],
        "archetype_phases": out["archetype_phases"][0],
    }


def generate_batch(specs: Sequence[TraceSpec],
                   seeds: Sequence[int]) -> Dict[str, np.ndarray]:
    """Stacked traces for ``specs`` × ``seeds``, shaped to feed
    ``simulate_sweep`` directly:

        lines i32[N, S, I, W, L], pcs i32[N, S, I, W],
        compute_gap f32[N, S] (or f32[N, S, I] if any spec's schedule
        varies intensity), archetype i32[N, S, W],
        oracle_wtype i32[N, S, I, W]

    Reshaping the leading two axes to one [N*S] axis gives the
    seed-stacked trace format ``simulate_sweep`` vmaps over, so one
    jitted call sweeps policies × seeds × workloads. All specs must share
    (n_instr, n_warps, lines_per_instr) — the trace shape.
    (``archetype_phases`` is a per-spec key only: schedules of different
    phase counts don't stack.)
    """
    shapes = {(s.n_instr, s.n_warps, s.lines_per_instr) for s in specs}
    if len(shapes) != 1:
        raise ValueError(f"heterogeneous trace shapes in batch: {shapes}")
    (n_instr, _, _), = shapes
    outs = [_sample_cells(s, seeds) for s in specs]
    for o in outs:                      # phase counts differ across specs
        o.pop("archetype_phases")
    gaps = [lowered_gap(s) for s in specs]
    if any(np.ndim(g) > 0 for g in gaps):
        gaps = [np.broadcast_to(np.asarray(g, np.float32), (n_instr,))
                for g in gaps]
        gap = np.broadcast_to(
            np.stack(gaps)[:, None, :],
            (len(specs), len(seeds), n_instr)).copy()
    else:
        gap = np.broadcast_to(
            np.asarray(gaps, np.float32)[:, None],
            (len(specs), len(seeds))).copy()
    return {
        "lines": np.stack([o["lines"] for o in outs]),
        "pcs": np.stack([o["pcs"] for o in outs]),
        "compute_gap": gap,
        "archetype": np.stack([o["archetype"] for o in outs]),
        "archetype2": np.stack([o["archetype2"] for o in outs]),
        "oracle_wtype": np.stack([o["oracle_wtype"] for o in outs]),
    }
