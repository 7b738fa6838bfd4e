"""Counter-based RNG primitives for trace generation, frozen for the
benchmark's reference: a copy of ``repro_torch.core.tracegen.rng``
(host-side numpy; torch's uint64 arithmetic is
incomplete, so the draws stay on ``np.uint64`` and the engines receive
torch tensors of the finished trace).

Every draw is a pure function of ``(stream_key, index)`` — there is no
sequential generator state, so the same cell yields the same bits
whatever order the cells are computed in.

The construction is splitmix64: a draw at index ``i`` of the stream with
key ``k`` finalizes the state ``k + i * GAMMA`` with the murmur-style
avalanche, on ``np.uint64`` (wrapping arithmetic); ``mix64_scalar`` is
its Python-int form for a trace's root key.
"""
from __future__ import annotations

import numpy as np

GAMMA = 0x9E3779B97F4A7C15
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
_MASK = (1 << 64) - 1

_U = np.uint64
_G = _U(GAMMA)
_M1u = _U(_M1)
_M2u = _U(_M2)

# named sub-stream tags: stream key = mix64(root + TAG * GAMMA)
TAG_ARCH = 1        # per-warp archetype draw
TAG_PHASE = 2       # per-warp phase-flip uniform
TAG_PHASE_PICK = 3  # per-warp flipped-archetype pick
TAG_WS = 4          # per-warp working-set permutation key
TAG_PC = 5          # per-warp PC table
TAG_POOL = 6        # shared-pool line addresses
TAG_REUSE_U = 7     # per-cell reuse uniform
TAG_SHARED_U = 8    # per-cell shared-pool uniform
TAG_SHARED_IDX = 9  # per-cell shared-pool index
TAG_WS_IDX = 10     # per-cell working-set index
# phased-schedule tags: indexed at p*W + w so every phase of
# every warp has its own coordinate; the legacy two-half path keeps its
# original TAG_PHASE/TAG_PHASE_PICK draws at index w, byte-identical
TAG_PHASE_MIX = 11  # per-(phase, warp) redrawn-archetype uniform
TAG_WS_CHURN = 12   # per-(phase, warp) working-set churn uniform
TAG_WS_KEY = 13     # per-(phase, warp) re-keyed working-set permutation

_INV53 = float(2.0 ** -53)


def mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer on uint64 arrays (wrapping arithmetic).
    np.errstate silences the overflow RuntimeWarning numpy emits for 0-d
    inputs — wraparound is the intended behaviour here."""
    with np.errstate(over="ignore"):
        z = np.asarray(x, _U)
        z = (z ^ (z >> _U(30))) * _M1u
        z = (z ^ (z >> _U(27))) * _M2u
        return z ^ (z >> _U(31))


def stream_key(root: np.ndarray, tag: int) -> np.ndarray:
    """Key for the named sub-stream ``tag`` of the trace rooted at ``root``."""
    with np.errstate(over="ignore"):
        return mix64(np.asarray(root, _U) + _U((tag * GAMMA) & _MASK))


def bits(key: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """64 random bits at ``idx`` of the stream ``key`` (broadcasting)."""
    with np.errstate(over="ignore"):
        return mix64(np.asarray(key, _U) + np.asarray(idx, _U) * _G)


def uniform(key: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """f64 uniforms in [0, 1) — top 53 bits of the draw."""
    return (bits(key, idx) >> _U(11)).astype(np.float64) * _INV53


def randint(key: np.ndarray, idx: np.ndarray, n) -> np.ndarray:
    """Integers in [0, n). Modulo bias is < n / 2**64 — negligible for the
    n <= 2**20 used here. ``n`` may be an array (per-warp working sets)."""
    return (bits(key, idx) % np.asarray(n, _U)).astype(np.int64)


# ---------------------------------------------------------------------------
# scalar (Python-int) mix, for a trace's root key
# ---------------------------------------------------------------------------

def mix64_scalar(x: int) -> int:
    z = x & _MASK
    z = ((z ^ (z >> 30)) * _M1) & _MASK
    z = ((z ^ (z >> 27)) * _M2) & _MASK
    return z ^ (z >> 31)


# ---------------------------------------------------------------------------
# keyed 12-bit permutation (working-set layout)
# ---------------------------------------------------------------------------

def perm12(j: np.ndarray, key: np.ndarray) -> np.ndarray:
    """Bijection on [0, 4096) keyed by ``key`` — a 3-round 6|6 Feistel
    whose round function is one mix64. Used to pick each warp's private
    working set without replacement (distinct lines by construction)."""
    with np.errstate(over="ignore"):
        j = np.asarray(j, _U)
        lo6 = _U(63)
        left, right = j >> _U(6), j & lo6
        for rnd in range(3):
            f = mix64(np.asarray(key, _U)
                      + (right | _U(rnd << 6)) * _G) & lo6
            left, right = right, left ^ f
        return ((left << _U(6)) | right).astype(np.int64)
