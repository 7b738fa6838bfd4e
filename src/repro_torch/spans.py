"""Named host intervals of the program's own layers, on the clock of
``time.perf_counter_ns``.

A site marks the work it does with ``span(name, key)``:

    with spans.span("serve.admit", req.rid):
        ...

and the span records its name, its start and end, the index of the span
that was open when it began (its parent, -1 at the top) and its ``key``
(a request id, or a step, wave or bucket index; -1 where none applies).
Spans go to one process-wide bounded buffer, ``SPANS``: the oldest are
dropped first and counted in ``SPANS.dropped``.

Spans record while a ``torch.profiler`` session is open, or between
``enable()`` and ``disable()``. Otherwise a site costs a check of two
module-level flags and returns a shared do-nothing context: nothing is
allocated and the clock is not read. A span that began while nothing
recorded stays unrecorded, even if recording starts inside it. The
buffer keeps one stack of open spans, for the one thread that runs the
program's loops.

``perf_counter_ns`` is the clock a host program also reads around a
``torch.profiler`` window, so spans line up with the device activity of
the profile without a conversion. ``SPANS.export_chrome(path)`` writes
them as Chrome trace events on the profiler's wall clock, to be laid over
``prof.export_chrome_trace()``.

The names, by layer:

* ``api.run`` (``Experiment.run``), its child ``api.compile``;
  ``api.execute`` (``Plan.execute``) and in it, per bucket (key: the
  bucket's index), ``api.tracegen`` (trace generation and stacking),
  ``api.simulate`` (the ``simulate_sweep`` call) and ``api.results``
  (the copy of the outputs to the host, which waits for the card);
* ``event.loop`` (the bucket's loop inputs and the event loop) and
  ``event.finalize`` (the per-simulation outputs);
* ``wave.step`` (one iteration of the wave loop, key: the wave) and in
  it ``wave.pending`` (the read of whether a warp is still active, which
  waits for the wave on the card);
* ``serve.step`` (one iteration of ``ServeEngine.run``, key: the step)
  and in it ``serve.admit`` (key: the request id) with its children
  ``serve.prefill``, ``serve.merge`` and ``serve.pool_insert``;
  ``serve.residency`` (every slot's block accesses) with a
  ``serve.restore`` a restored block (key: the request id);
  ``serve.decode`` (the batched decode step) and ``serve.stream_out``
  (streamed blocks offloaded after the step).
"""
from __future__ import annotations

import collections
import json
import os
import time
from typing import Deque, List, NamedTuple

from torch.autograd import profiler as _profiler

#: spans the buffer holds before it drops the oldest
CAPACITY = 1 << 18

_on = False


class _Off:
    """The shared context a site gets while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class Span(NamedTuple):
    """One recorded interval; ``raised`` is set where its body raised."""
    name: str
    t0: int               # perf_counter_ns
    t1: int
    index: int            # this span's index, counted from the first
    parent: int           # the index of the span open when it began
    key: int
    raised: bool


class SpanBuffer:
    """The bounded buffer of finished spans, oldest first by their end;
    ``items`` holds each as a plain tuple in ``Span``'s field order."""

    def __init__(self, capacity: int = CAPACITY):
        self.items: Deque[tuple] = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._next = 0
        self._open: List[int] = []

    def _end(self, rec: "_Open", raised: bool) -> None:
        t1 = time.perf_counter_ns()
        self._open.pop()
        if len(self.items) == self.items.maxlen:
            self.dropped += 1
        self.items.append((rec.name, rec.t0, t1, rec.index, rec.parent,
                           rec.key, raised))

    def between(self, t0_ns: int, t1_ns: int) -> List[Span]:
        """The spans that overlap [t0_ns, t1_ns], whole, by start."""
        return sorted((Span(*s) for s in self.items
                       if s[1] < t1_ns and s[2] > t0_ns),
                      key=lambda s: (s.t0, s.index))

    def export_chrome(self, path: str, base_ns: int = 0) -> None:
        """Write every span held as Chrome trace events (``"ph": "X"``,
        microseconds). ``ts`` counts from ``base_ns`` on the wall clock
        (``time.time_ns``), the file's ``baseTimeNanoseconds``, as
        ``torch.profiler``'s own export does: pass that file's value to
        put both on one timeline."""
        offset = time.time_ns() - time.perf_counter_ns() - base_ns
        pid = os.getpid()
        events = [{"name": s.name, "cat": "repro_torch", "ph": "X",
                   "ts": (s.t0 + offset) / 1e3, "dur": (s.t1 - s.t0) / 1e3,
                   "pid": pid, "tid": "spans",
                   "args": {"key": s.key, "index": s.index,
                            "parent": s.parent, "raised": s.raised}}
                  for s in sorted(map(Span._make, self.items),
                                  key=lambda s: s.index)]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": base_ns}, f)


class _Open:
    """A span being recorded (the context manager ``span`` returns)."""
    __slots__ = ("buf", "name", "key", "index", "parent", "t0")

    def __init__(self, name: str, key: int):
        self.name, self.key = name, key

    def __enter__(self):
        buf = self.buf = SPANS
        self.index = buf._next
        buf._next += 1
        self.parent = buf._open[-1] if buf._open else -1
        buf._open.append(self.index)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.buf._end(self, exc_type is not None)
        return False


SPANS = SpanBuffer()


def span(name: str, key: int = -1):
    """A context manager that records ``name`` over its body while spans
    record (a profiler session, or ``enable()``), and does nothing
    otherwise."""
    if not (_on or _profiler._is_profiler_enabled):
        return _OFF
    return _Open(name, int(key))


def enable() -> None:
    """Record spans from now on, with or without a profiler session."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording outside a profiler session (spans held stay)."""
    global _on
    _on = False

