"""Host spans and the device trace of a traced window.

``Spans`` records named host intervals that the benchmark's own wrappers
open around calls into the program's layers. ``DeviceTrace`` runs
``torch.profiler`` (CUDA activity only) over a window and reduces what
ran on the device to a ``TraceSummary``: every kernel, copy and set with
its name, start and length on the host's clock, the union of busy time,
and the idle gaps between. ``breakdown`` names the operations that took
most of the device and the host spans that the idle gaps fell into.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


class Spans:
    """Named host intervals, on ``time.perf_counter_ns``."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter_ns()))

    def wrap(self, name: str, fn):
        """``fn`` with each call recorded as a span ``name``."""
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped

    def labels_at(self, times: List[int]) -> List[Optional[str]]:
        """For each time (ns), the innermost (latest-starting) span that
        covers it, or None: one sweep over spans and times in order."""
        spans = sorted(self.items, key=lambda s: s[1])
        out: List[Optional[str]] = [None] * len(times)
        active: list = []          # heap of (-start, end, name)
        k = 0
        for i in sorted(range(len(times)), key=times.__getitem__):
            t = times[i]
            while k < len(spans) and spans[k][1] <= t:
                heapq.heappush(active, (-spans[k][1], spans[k][2],
                                        spans[k][0]))
                k += 1
            while active and active[0][1] < t:
                heapq.heappop(active)
            if active:
                out[i] = active[0][2]
        return out


@dataclasses.dataclass
class TraceSummary:
    """What ran on the device in a window [t0_ns, t1_ns] of the host's
    ``perf_counter_ns`` clock."""
    t0_ns: int
    t1_ns: int
    ops: List[Tuple[int, int, str]]       # (start_ns, end_ns, name)
    busy_s: float
    gaps: List[Tuple[int, int]]           # idle intervals

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def kernel(self, fragment: str) -> Tuple[float, int]:
        """Device seconds and launches of the operations whose name
        holds ``fragment``."""
        hit = [(b - a) for a, b, n in self.ops if fragment in n]
        return sum(hit) / 1e9, len(hit)

    def by_name(self) -> Dict[str, float]:
        acc: Dict[str, float] = defaultdict(float)
        for a, b, n in self.ops:
            acc[n] += (b - a) / 1e9
        return dict(acc)


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def _device_events(prof) -> List[Tuple[int, int, str]]:
    """(start_ns, end_ns, name) of every device activity in a finished
    profile, on the profiler's clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != "CUDA":
            continue
        a = e.start_ns()
        out.append((a, a + e.duration_ns(), e.name()))
    return out


class DeviceTrace:
    """``torch.profiler`` over one window. ``warm()`` once in set-up
    starts and stops it, so the window does not pay the tracer's first
    start."""

    def __init__(self):
        self._prof = None
        self._t0 = self._offset = 0

    @staticmethod
    def _profile():
        import torch
        return torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])

    def warm(self) -> None:
        import torch
        with self._profile():
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        torch.cuda.synchronize()
        self._prof = self._profile()
        self._prof.__enter__()
        # the profiler stamps device activity on the wall clock (ns)
        self._offset = time.time_ns() - time.perf_counter_ns()
        self._t0 = time.perf_counter_ns()

    @property
    def running(self) -> bool:
        return self._prof is not None

    def stop(self) -> TraceSummary:
        import torch
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        self._prof.__exit__(None, None, None)
        events = _device_events(self._prof)
        self._prof = None
        return summarize(events, self._offset, self._t0, t1)


def summarize(events, offset: int, t0: int, t1: int) -> TraceSummary:
    """The summary of device ``events`` ((start, end, name) on the
    profiler's clock, ``offset`` ns ahead of the host's) over the host
    window [t0, t1]: each operation clipped to the window, the union of
    their intervals as the busy time, and the gaps between."""
    ops = sorted((max(a - offset, t0), min(b - offset, t1), n)
                 for a, b, n in events)
    ops = [o for o in ops if o[1] > o[0]]
    busy, gaps, cur = 0, [], t0
    for a, b, _ in ops:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if t1 > cur:
        gaps.append((cur, t1))
    return TraceSummary(t0, t1, ops, busy / 1e9, gaps)


def breakdown(summary: TraceSummary, spans: Spans,
              top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle time by
    what the host was doing (the innermost benchmark span over each
    gap's middle; ``host`` where none was open)."""
    ops = sorted(summary.by_name().items(), key=lambda kv: -kv[1])[:top]
    idle: Dict[str, float] = defaultdict(float)
    labels = spans.labels_at([(a + b) // 2 for a, b in summary.gaps])
    for (a, b), label in zip(summary.gaps, labels):
        idle[label or "host"] += (b - a) / 1e9
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[_short(n), s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
