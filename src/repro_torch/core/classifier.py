"""Online warp-type identification (paper §3.1, mechanism ①), in torch.

Two counters per warp (hits, accesses) incremented at the shared cache,
sampled every ``sampling_interval`` accesses; at each sampling boundary
the warp's type is re-evaluated from the observed hit ratio and the
counters reset. ``accesses`` counts every valid request (the window and
probe cadence clock); ``sampled`` counts only the requests that took the
cache path (non-bypassed plus the periodic probes), and the classified
ratio is ``hits / sampled``. ``max_windows`` caps how many windows may
update the label (1 = the stale, classify-once labeling).

The classify floor adapts to the probe cadence (``min_probe_samples``):
a window of ``interval`` accesses guarantees only ``interval /
probe_interval`` cache-path samples for a fully-bypassing warp.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import warp_types as WT

F32 = torch.float32
I32 = torch.int32


class ClassifierState(NamedTuple):
    hits: torch.Tensor        # i32[W] cache-path hits in current window
    accesses: torch.Tensor    # i32[W] ALL valid requests in current window
    warp_type: torch.Tensor   # i32[W] current classification
    ratio: torch.Tensor       # f32[W] last sampled cache-path hit ratio
    windows: torch.Tensor     # i32[W] completed sampling windows
    sampled: torch.Tensor     # i32[W] cache-path requests in current window


def init(n_warps: int, device="cpu") -> ClassifierState:
    return ClassifierState(
        hits=torch.zeros((n_warps,), dtype=I32, device=device),
        accesses=torch.zeros((n_warps,), dtype=I32, device=device),
        warp_type=torch.full((n_warps,), WT.BALANCED, dtype=I32,
                             device=device),
        ratio=torch.full((n_warps,), 0.5, dtype=F32, device=device),
        windows=torch.zeros((n_warps,), dtype=I32, device=device),
        sampled=torch.zeros((n_warps,), dtype=I32, device=device),
    )


def min_probe_samples(sampling_interval, probe_interval):
    """Classify floor adapted to the probe cadence:
    ``clip(interval // max(probe_interval, 1), 1, 8)`` in float32 (float
    floor division, as the reference)."""
    interval = torch.as_tensor(sampling_interval).to(F32)
    probe = torch.as_tensor(probe_interval).to(F32)
    guaranteed = torch.div(interval, torch.clamp_min(probe, 1.0),
                           rounding_mode="floor")
    return torch.clamp(guaranteed, 1.0, 8.0)


def observe(state: ClassifierState, warp_id, is_hit, *,
            sampling_interval=256,
            mostly_hit_threshold: float = 0.8,
            mostly_miss_threshold: float = 0.2,
            weight=None, max_windows=None, probed=None,
            probe_interval=None) -> ClassifierState:
    """Record one (or a batch of) access outcome(s) and re-classify any warp
    whose sampling window filled up.

    warp_id: i32[N]; is_hit: bool[N]. ``weight`` (i32, default 1) is
    added to the cadence clock, ``probed`` (i32, default ``weight``)
    marks the cache-path samples. ``sampling_interval``, ``max_windows``
    and ``probe_interval`` may be tensors. Duplicate warp ids add up
    (``index_add_``, exact in any order).
    """
    warp_id = torch.atleast_1d(torch.as_tensor(warp_id)).to(torch.int64)
    is_hit = torch.atleast_1d(torch.as_tensor(is_hit)).to(I32)
    if weight is None:
        weight = torch.ones_like(is_hit)
    if probed is None:
        probed = weight
    weight = torch.as_tensor(weight).to(I32)
    probed = torch.as_tensor(probed).to(I32)
    hits = state.hits.index_add(0, warp_id, is_hit * probed)
    accesses = state.accesses.index_add(0, warp_id, weight)
    sampled = state.sampled.index_add(0, warp_id, probed)

    due = accesses >= sampling_interval
    ratio_now = hits.to(F32) / torch.clamp_min(sampled, 1)
    min_samples = 8 if probe_interval is None \
        else min_probe_samples(sampling_interval, probe_interval)
    new_type = WT.classify(ratio_now, sampled,
                           mostly_hit_threshold=mostly_hit_threshold,
                           mostly_miss_threshold=mostly_miss_threshold,
                           min_samples=min_samples)
    relabel = due if max_windows is None \
        else due & (state.windows < max_windows)
    return ClassifierState(
        hits=torch.where(due, 0, hits).to(I32),
        accesses=torch.where(due, 0, accesses).to(I32),
        warp_type=torch.where(relabel, new_type, state.warp_type),
        ratio=torch.where(due, ratio_now, state.ratio),
        windows=state.windows + due.to(I32),
        sampled=torch.where(due, 0, sampled).to(I32))


def force_classify(state: ClassifierState, *, mostly_hit_threshold=0.8,
                   mostly_miss_threshold=0.2, min_samples: int = 1
                   ) -> ClassifierState:
    """Classify immediately from whatever counts exist (end-of-window):
    warps with at least ``min_samples`` cache-path samples take the type
    and ratio of their current counts; the others keep theirs. Counters
    are left as they are."""
    ratio_now = state.hits.to(F32) / torch.clamp_min(state.sampled, 1)
    new_type = WT.classify(ratio_now, state.sampled,
                           mostly_hit_threshold=mostly_hit_threshold,
                           mostly_miss_threshold=mostly_miss_threshold,
                           min_samples=min_samples)
    keep = state.sampled < min_samples
    return state._replace(
        warp_type=torch.where(keep, state.warp_type, new_type),
        ratio=torch.where(keep, state.ratio, ratio_now))
