"""The serving traffic generator: one traffic mix's parameters and a seed
in, a list of requests out.

The sizes of a mix do not depend on the seed. A *deck* of
``deck`` requests is laid out once from the parameters: a ``chat_frac``
share of chat requests (a shared prefix, a short unique prompt), the rest
RAG requests (a long unique context). A length is given either as a
range ``[lo, hi)``, laid out at evenly spaced quantiles, or as a
log-normal ``{"median": m, "mean": mu}``, laid out at the midpoint
quantiles of the log-normal with that median and mean, so the deck holds
the distribution's tail in its share. Decode lengths are paired with
prompts by a fixed shuffle; where ``max_context`` is given, a prompt is
cut so that prompt and decode fit it, as a deployment's context limit
does. Every consecutive group of ``deck`` requests is the deck in an
order drawn from the seed, and requests arrive one each
``1 / arrival_rate`` engine steps. So every seed serves the same mix of
sizes in any stretch of the stream, in another order, and two seeds'
runs differ by the order of the work and not by its amount.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import List, Mapping, Optional, Sequence, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class Req:
    rid: int
    prompt_len: int
    decode_len: int
    shared_prefix_id: Optional[int]
    shared_prefix_len: int
    arrival: float


def _spread(spec: Union[Sequence[int], Mapping], n: int) -> np.ndarray:
    """``n`` integers at the midpoint quantiles of a length ``spec``: a
    range ``[lo, hi)``, or a log-normal given by its median and mean."""
    q = (np.arange(n) + 0.5) / n
    if isinstance(spec, Mapping):
        sigma = math.sqrt(2.0 * math.log(spec["mean"] / spec["median"]))
        z = np.array([statistics.NormalDist().inv_cdf(x) for x in q])
        return np.maximum(np.rint(spec["median"] * np.exp(sigma * z)),
                          1).astype(np.int64)
    lo, hi = spec
    return (lo + q * (hi - lo)).astype(np.int64)


def deck(p: Mapping) -> List[dict]:
    """The mix's sizes, in a fixed order."""
    n = p["deck"]
    n_chat = int(round(p["chat_frac"] * n))
    fixed = np.random.default_rng(p.get("deck_seed", 0))
    chat = _spread(p["chat_prompt"], n_chat) if n_chat else []
    rag = _spread(p["rag_prompt"], n - n_chat) if n - n_chat else []
    decode = fixed.permutation(_spread(p["decode"], n))
    out = []
    for k in range(n):
        is_chat = k < n_chat
        prefix = p["shared_prefix_len"] if is_chat else 0
        prompt = int(chat[k] if is_chat else rag[k - n_chat])
        if "max_context" in p:
            prompt = min(prompt, p["max_context"] - prefix - int(decode[k]))
        out.append(dict(
            prompt_len=prompt,
            decode_len=int(decode[k]),
            shared_prefix_id=(k % p["n_shared_prefixes"]) if is_chat
            else None,
            shared_prefix_len=prefix))
    return out


def generate(p: Mapping, seed: int) -> List[Req]:
    """``p["n_requests"]`` requests of the mix ``p`` for ``seed``."""
    cards = deck(p)
    rng = np.random.default_rng(seed)
    out: List[Req] = []
    while len(out) < p["n_requests"]:
        for k in rng.permutation(len(cards)):
            if len(out) == p["n_requests"]:
                break
            rid = len(out)
            out.append(Req(rid=rid, arrival=(rid + 1) / p["arrival_rate"],
                           **cards[k]))
    return out


def prompt_tokens(req: Req, vocab: int) -> np.ndarray:
    """The prompt the engine serves for ``req``: its shared prefix's
    tokens (drawn from 1000 + prefix id), then its own (from 2000 +
    rid), all in [1, vocab). The engine draws them by this rule from the
    request's ids; the reference draws them again."""
    parts = []
    if req.shared_prefix_id is not None:
        parts.append(np.random.default_rng(1000 + req.shared_prefix_id)
                     .integers(1, vocab, req.shared_prefix_len))
    parts.append(np.random.default_rng(2000 + req.rid)
                 .integers(1, vocab, req.prompt_len))
    return np.concatenate(parts).astype(np.int64)
