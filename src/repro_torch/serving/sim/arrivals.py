"""Open-loop arrival processes from the splitmix64 counter RNG.

Every stream is an inhomogeneous Poisson process generated the same way:
draw a unit-rate Poisson event sequence (exponential gaps, each a pure
function of ``(stream_key, index)`` — the tracegen construction, so
streams are deterministic and seed-stackable), then warp event times
through the inverse integrated rate Λ⁻¹:

    poisson   Λ(t) = r·t                       (identity up to scale)
    bursty    Λ(t) = square-wave rate           (piecewise-linear, closed
              (hi = r·boost for duty·period)     form inverse)
    diurnal   Λ(t) = r·(t + amp·P/2π·(1−cos))   (monotone; vectorized
                                                 bisection inverse)
    closed    every arrival at t = 0            (ServeEngine parity case)

Request attributes (chat/RAG class, prompt/decode lengths, shared-prefix
id) come from dedicated counter sub-streams at index = request id, so a
request's identity is stable regardless of how many others exist.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.tracegen import rng
from repro_torch.core.tracegen.spec import trace_key
from repro_torch.serving.sim.spec import ServingSpec

# serving-only counter sub-streams (tracegen's tags stop at 13)
TAG_SERVE_GAP = 21      # unit-rate Poisson gaps
TAG_SERVE_CLASS = 22    # chat-vs-RAG class uniform
TAG_SERVE_PROMPT = 23   # prompt-length draw
TAG_SERVE_DECODE = 24   # decode-length draw
TAG_SERVE_PREFIX = 25   # shared-prefix pick

_BISECT_ITERS = 64


def _unit_poisson(root: int, n: int) -> np.ndarray:
    """Event times of a unit-rate Poisson process (f64[n], increasing)."""
    u = rng.uniform(rng.stream_key(np.uint64(root), TAG_SERVE_GAP),
                    np.arange(n))
    return np.cumsum(-np.log1p(-u))


def _warp_bursty(t_unit: np.ndarray, spec: ServingSpec) -> np.ndarray:
    """Closed-form Λ⁻¹ for the square-wave (MMPP-style) rate."""
    hi = spec.rate * spec.burst_boost
    lo = spec.rate * (1.0 - spec.burst_duty * spec.burst_boost) \
        / (1.0 - spec.burst_duty)
    p = spec.burst_period
    t_on = spec.burst_duty * p
    mass_on = hi * t_on
    mass = spec.rate * p                      # Λ over one full period
    n_full = np.floor(t_unit / mass)
    rem = t_unit - n_full * mass
    in_burst = rem <= mass_on
    t_in = np.where(in_burst, rem / hi,
                    t_on + (rem - mass_on) / max(lo, 1e-300))
    return n_full * p + t_in


def _warp_diurnal(t_unit: np.ndarray, spec: ServingSpec) -> np.ndarray:
    """Vectorized bisection inverse of the sinusoidal integrated rate."""
    r, amp, p = spec.rate, spec.diurnal_amp, spec.diurnal_period
    w = 2.0 * np.pi / p

    def lam(t):
        return r * (t + amp / w * (1.0 - np.cos(w * t)))

    # Λ(t) is within r·amp·P/π of r·t, so bracket around t_unit / r
    c = r * amp * p / np.pi
    lo = np.maximum((t_unit - c) / r, 0.0)
    hi = (t_unit + c) / r + 1e-9
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        below = lam(mid) < t_unit
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return 0.5 * (lo + hi)


def arrival_times(spec: ServingSpec, seed: int = 0) -> np.ndarray:
    """Arrival times (engine steps, f64[n], non-decreasing) of the
    spec's open-loop process for one seed."""
    n = spec.n_requests
    if n == 0:
        return np.empty(0, np.float64)
    if spec.process == "closed":
        return np.zeros(n, np.float64)
    t_unit = _unit_poisson(trace_key(spec.name, seed), n)
    if spec.process == "poisson":
        return t_unit / spec.rate
    if spec.process == "bursty":
        return _warp_bursty(t_unit, spec)
    return _warp_diurnal(t_unit, spec)


def generate_serving(spec: ServingSpec, seed: int = 0
                     ) -> Dict[str, np.ndarray]:
    """The full request stream for one (spec, seed): ``arrival`` f64[n]
    plus i64[n] ``prompt_len``/``decode_len``/``prefix_id`` (-1 for
    RAG) / ``prefix_len``. The sequence's true class (chat = shared-hot,
    RAG = streaming-cold) is ``prefix_id >= 0`` — it is NOT declared to
    the runtime; the classifier must discover it (the oracle labeling
    mode is the exception, by design)."""
    n = spec.n_requests
    root = np.uint64(trace_key(spec.name, seed))
    idx = np.arange(n)
    chat = rng.uniform(rng.stream_key(root, TAG_SERVE_CLASS), idx) \
        < spec.chat_frac
    c_lo, c_hi = spec.chat_prompt
    r_lo, r_hi = spec.rag_prompt
    kp = rng.stream_key(root, TAG_SERVE_PROMPT)
    prompt = np.where(chat,
                      c_lo + rng.randint(kp, idx, max(c_hi - c_lo, 1)),
                      r_lo + rng.randint(kp, idx, max(r_hi - r_lo, 1)))
    d_lo, d_hi = spec.decode
    decode = d_lo + rng.randint(rng.stream_key(root, TAG_SERVE_DECODE),
                                idx, max(d_hi - d_lo, 1))
    prefix_id = np.where(chat,
                         rng.randint(rng.stream_key(root, TAG_SERVE_PREFIX),
                                     idx, max(spec.n_shared_prefixes, 1)),
                         -1)
    return {
        "arrival": arrival_times(spec, seed),
        "prompt_len": prompt.astype(np.int64),
        "decode_len": decode.astype(np.int64),
        "prefix_id": prefix_id.astype(np.int64),
        "prefix_len": np.where(chat, spec.shared_prefix_len, 0
                               ).astype(np.int64),
    }


def from_requests(requests: List) -> Dict[str, np.ndarray]:
    """Array form of a ``request.generate_requests`` list — the bridge
    the ServeEngine parity suite uses to feed both implementations the
    IDENTICAL closed-loop workload."""
    return {
        "arrival": np.asarray([r.arrival for r in requests], np.float64),
        "prompt_len": np.asarray([r.prompt_len for r in requests],
                                 np.int64),
        "decode_len": np.asarray([r.decode_len for r in requests],
                                 np.int64),
        "prefix_id": np.asarray(
            [-1 if r.shared_prefix_id is None else r.shared_prefix_id
             for r in requests], np.int64),
        "prefix_len": np.asarray([r.shared_prefix_len for r in requests],
                                 np.int64),
    }
