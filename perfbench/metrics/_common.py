"""Shared arithmetic of the per-layer readers (this file is no metric:
its name starts with an underscore)."""
from __future__ import annotations

from typing import Iterable, Optional

from perfbench.reference import peaks


def idle_pct(ctx) -> Optional[float]:
    t = ctx.trace
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def device_s(ctx, fragments: Iterable[str]) -> float:
    return sum(ctx.trace.kernel(f)[0] for f in fragments)


def share(ctx, fragments: Iterable[str], calls: Iterable[dict],
          op_peak: Optional[float] = None) -> Optional[float]:
    """Roofline share of the kernels named by ``fragments`` over the
    traced window: the least time of every call (``{"ops", "bytes",
    "n"}``: ``n`` launches of that count; a call without ``ops`` is
    bounded by its bytes) over their device time."""
    dev = device_s(ctx, fragments)
    least = sum(c.get("n", 1) * peaks.least_time(c.get("ops", 0.0),
                                                  c["bytes"], op_peak)[0]
                for c in calls)
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / dev
