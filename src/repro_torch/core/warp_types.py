"""Warp-type taxonomy (paper Fig 3), in torch.

Five types keyed by shared-cache hit ratio, sampled over an interval:

    all-miss     ratio == 0
    mostly-miss  0 < ratio <= mostly_miss_threshold   (paper: ~20%)
    balanced     mmiss < ratio < mostly_hit_threshold
    mostly-hit   mhit <= ratio < 1
    all-hit      ratio == 1

Codes are ordered so that *larger code == higher cache utility*, which lets
the policies compare with a single threshold (e.g. bypass iff
type <= MOSTLY_MISS, prioritize iff type >= MOSTLY_HIT).

``classify`` compares float32 ratios with Python-float thresholds; torch
rounds the scalar to the tensor's float32, exactly as JAX's weakly typed
scalars do, so the ladder is bitwise the reference's. The numpy forms
(``classify_np``, ``oracle_type_np``) serve the host-side trace generator.
"""
from __future__ import annotations

import numpy as np
import torch

ALL_MISS = 0
MOSTLY_MISS = 1
BALANCED = 2
MOSTLY_HIT = 3
ALL_HIT = 4

NUM_TYPES = 5
TYPE_NAMES = ("all-miss", "mostly-miss", "balanced", "mostly-hit", "all-hit")

# epsilon so that e.g. 127/128 still counts as mostly-hit, not all-hit
_EPS = 1e-6


def classify(hit_ratio: torch.Tensor, accesses: torch.Tensor, *,
             mostly_hit_threshold: float = 0.8,
             mostly_miss_threshold: float = 0.2, min_samples=8):
    """Vectorized hit-ratio -> warp-type. Unsampled warps default BALANCED.

    hit_ratio: f32[...] in [0,1]; accesses: i32[...] sample counts;
    min_samples: a Python number or an f32 0-d tensor.
    """
    r = hit_ratio
    t = torch.full(r.shape, BALANCED, dtype=torch.int32, device=r.device)
    t = torch.where(r <= mostly_miss_threshold, MOSTLY_MISS, t)
    t = torch.where(r <= _EPS, ALL_MISS, t)
    t = torch.where(r >= mostly_hit_threshold, MOSTLY_HIT, t)
    t = torch.where(r >= 1.0 - _EPS, ALL_HIT, t)
    return torch.where(accesses >= min_samples, t, BALANCED)


def _ladder_np(hit_ratio, mostly_hit_threshold: float,
               mostly_miss_threshold: float) -> np.ndarray:
    """The ratio->type threshold ladder, numpy-vectorized in float32 (the
    same comparisons ``classify`` makes)."""
    r = np.asarray(hit_ratio, np.float32)
    t = np.full(r.shape, BALANCED, np.int32)
    t = np.where(r <= np.float32(mostly_miss_threshold), MOSTLY_MISS, t)
    t = np.where(r <= np.float32(_EPS), ALL_MISS, t)
    t = np.where(r >= np.float32(mostly_hit_threshold), MOSTLY_HIT, t)
    t = np.where(r >= np.float32(1.0 - _EPS), ALL_HIT, t)
    return t


def classify_np(hit_ratio: float, accesses: int, *,
                mostly_hit_threshold: float = 0.8,
                mostly_miss_threshold: float = 0.2,
                min_samples: int = 8) -> int:
    """Scalar numpy mirror of `classify` for host-side control planes."""
    if accesses < min_samples:
        return BALANCED
    return int(_ladder_np(hit_ratio, mostly_hit_threshold,
                          mostly_miss_threshold))


def oracle_type_np(reuse_p, ws_lines, *, mostly_hit_threshold: float = 0.8,
                   mostly_miss_threshold: float = 0.2) -> np.ndarray:
    """Ground-truth labeling from lowered trace params: the type a
    converged classifier would settle on, given the phase's reuse
    probability and working-set size (0 lines = pure streaming =
    all-miss). Used by tracegen to emit the per-phase oracle labels."""
    t = _ladder_np(reuse_p, mostly_hit_threshold, mostly_miss_threshold)
    return np.where(np.asarray(ws_lines) == 0,
                    np.int32(ALL_MISS), t).astype(np.int32)


def is_bypass_type(warp_type):
    """Mostly-miss and all-miss warps bypass the shared cache (paper §3.2)."""
    return warp_type <= MOSTLY_MISS


def is_priority_type(warp_type):
    """Mostly-hit (and mischaracterized all-hit) requests take the
    high-priority memory queue (paper §3.4)."""
    return warp_type >= MOSTLY_HIT


def insertion_rank(warp_type: torch.Tensor, max_rank: int = 3):
    """Warp-type -> RRIP-style insertion rank (paper §3.3): all/mostly-hit
    -> 0 (MRU), balanced -> max_rank-1, mostly/all-miss -> max_rank."""
    r = torch.full(warp_type.shape, max_rank, dtype=torch.int32,
                   device=warp_type.device)
    r = torch.where(warp_type == BALANCED, max_rank - 1, r)
    return torch.where(warp_type >= MOSTLY_HIT, 0, r)
