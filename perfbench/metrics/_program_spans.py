"""Shared arithmetic of the readers of the program's own spans
(``repro_torch.spans``; this file is no metric: its name starts with an
underscore): the spans of a name in the traced window, clipped to it;
their summed length; the device's idle time inside them. A program
without spans gives none, and each reader then returns None."""
from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

Interval = Tuple[int, int]


def program_spans(ctx) -> list:
    """The program's spans that overlap the traced window, whole, in the
    order they began (none where the program records no spans)."""
    try:
        from repro_torch.spans import SPANS
    except ImportError:
        return []
    return SPANS.between(ctx.trace.t0_ns, ctx.trace.t1_ns)


def clipped(ctx, name: str, spans=None) -> List[Interval]:
    """(start, end) in ns of every span ``name`` that overlaps the window
    and closed without raising (a body cut short is no unit of work),
    clipped to the window."""
    t0, t1 = ctx.trace.t0_ns, ctx.trace.t1_ns
    spans = program_spans(ctx) if spans is None else spans
    return [(max(s.t0, t0), min(s.t1, t1)) for s in spans
            if s.name == name and not s.raised]


def merged(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``intervals`` as disjoint intervals in order."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def idle_ns(ctx, intervals: Sequence[Interval]) -> int:
    """Nanoseconds of the window's device-idle gaps that fall inside the
    union of ``intervals``."""
    gaps = ctx.trace.gaps                  # disjoint, in order
    starts = [g[0] for g in gaps]
    cum = [0]
    for a, b in gaps:
        cum.append(cum[-1] + (b - a))

    def upto(t: int) -> int:               # idle time before t
        i = bisect.bisect_right(starts, t)
        return cum[i] - max(0, gaps[i - 1][1] - t) if i else 0
    return sum(upto(b) - upto(a) for a, b in merged(intervals))


def per_span(ctx, name: str, over: Optional[str] = None,
             idle: bool = False) -> Optional[float]:
    """Milliseconds of the window's ``name`` spans (only their
    device-idle part where ``idle``) over the count of its ``over``
    spans (default ``name``); None where there are none."""
    spans = program_spans(ctx)
    den = len(clipped(ctx, over or name, spans))
    if not den:
        return None
    got = clipped(ctx, name, spans)
    ns = idle_ns(ctx, got) if idle else sum(b - a for a, b in got)
    return ns / den / 1e6
