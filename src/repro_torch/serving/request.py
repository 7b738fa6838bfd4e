"""Serving request model + workload generator.

Heterogeneity mirrors the paper's warp populations: chat-style requests
share hot prefix blocks (high pool utility — the mostly/all-hit class)
while long-unique-context (RAG-style) requests stream cold blocks through
the pool (the mostly/all-miss class). Which class a *sequence* lands in is
NOT declared to the runtime — the MeDiC classifier must discover it from
observed residency hit ratios.

Host numpy, copied from ``repro.serving.request`` (bit-exact:
``np.random.default_rng(seed)`` draws in the same order).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    decode_len: int
    shared_prefix_id: Optional[int]   # id of a shared system-prompt prefix
    shared_prefix_len: int
    arrival: float                    # engine-step time of arrival
    # runtime state
    slot: int = -1
    generated: int = 0
    stall_steps: int = 0
    enqueue_step: int = 0
    first_token_step: int = -1
    finish_step: int = -1


@dataclasses.dataclass(frozen=True)
class ServeWorkload:
    name: str = "chat_rag_mix"
    n_requests: int = 64
    chat_frac: float = 0.6           # share of requests with hot prefixes
    n_shared_prefixes: int = 2
    shared_prefix_len: int = 48      # tokens (multiple of block size ideally)
    chat_prompt: tuple = (16, 48)    # unique prompt tokens, uniform range
    rag_prompt: tuple = (192, 384)   # long unique contexts
    decode: tuple = (32, 96)
    arrival_rate: float = 2.0        # requests per engine step


def generate_requests(wl: ServeWorkload, seed: int = 0) -> List[Request]:
    rng = np.random.default_rng(seed)
    reqs = []
    t = 0.0
    for rid in range(wl.n_requests):
        t += rng.exponential(1.0 / wl.arrival_rate)
        if rng.random() < wl.chat_frac:
            reqs.append(Request(
                rid=rid,
                prompt_len=int(rng.integers(*wl.chat_prompt)),
                decode_len=int(rng.integers(*wl.decode)),
                shared_prefix_id=int(rng.integers(0, wl.n_shared_prefixes)),
                shared_prefix_len=wl.shared_prefix_len,
                arrival=t,
            ))
        else:
            reqs.append(Request(
                rid=rid,
                prompt_len=int(rng.integers(*wl.rag_prompt)),
                decode_len=int(rng.integers(*wl.decode)),
                shared_prefix_id=None,
                shared_prefix_len=0,
                arrival=t,
            ))
    return reqs
