"""The readers of the program's spans (``metrics/_program_spans.py``):
spans clipped to the traced window, the device's idle time inside them
from hand-made spans and gaps, and nothing without a denominator or
without spans in the program."""
from __future__ import annotations

import sys
import types

import pytest

from perfbench.harness import spec as S
from perfbench.harness.trace import summarize
from perfbench.metrics import _program_spans as PS
from repro_torch import spans as SP


def _ctx(t0, t1, ops=()):
    return types.SimpleNamespace(trace=summarize(list(ops), 0, t0, t1))


@pytest.fixture
def fake(monkeypatch):
    """A buffer of hand-made spans in place of the program's."""
    buf = SP.SpanBuffer()
    monkeypatch.setattr(SP, "SPANS", buf)

    def add(name, t0, t1, key=-1, raised=False, parent=-1):
        buf.items.append((name, t0, t1, len(buf.items), parent, key,
                          raised))
    return add


def test_spans_clip_to_the_window(fake):
    fake("a", 0, 150)          # starts before the window
    fake("a", 200, 300)
    fake("a", 950, 1200)       # ends after it
    fake("a", 1300, 1400)      # outside
    fake("b", 400, 500)
    fake("a", 600, 700, raised=True)
    ctx = _ctx(100, 1000)
    assert PS.clipped(ctx, "a") == [(100, 150), (200, 300), (950, 1000)]
    assert PS.clipped(ctx, "b") == [(400, 500)]
    # 200 ns over three spans of "a" (the one that raised is no unit)
    assert PS.per_span(ctx, "a") == pytest.approx(200 / 3 / 1e6)
    assert PS.per_span(ctx, "a", over="b") == pytest.approx(200 / 1e6)


def test_idle_inside_spans_from_hand_made_gaps(fake):
    # device busy [0, 10), [30, 40), [55, 60) in a window [0, 100):
    # gaps (10, 30), (40, 55), (60, 100)
    ctx = _ctx(0, 100, [(0, 10, "k"), (30, 40, "k"), (55, 60, "k")])
    assert ctx.trace.gaps == [(10, 30), (40, 55), (60, 100)]
    assert PS.idle_ns(ctx, [(0, 100)]) == 75
    assert PS.idle_ns(ctx, [(5, 35)]) == 20
    assert PS.idle_ns(ctx, [(12, 14), (45, 70)]) == 2 + 10 + 10
    # overlapping spans count their union once
    assert PS.idle_ns(ctx, [(5, 35), (20, 45)]) == 25
    assert PS.idle_ns(ctx, [(31, 39)]) == 0
    fake("s", 5, 35)
    fake("s", 45, 70)
    assert PS.per_span(ctx, "s", idle=True) == pytest.approx(
        (20 + 20) / 2 / 1e6)


def test_nothing_to_read_reads_nothing(fake, monkeypatch):
    ctx = _ctx(0, 100, [(0, 10, "k")])
    assert PS.per_span(ctx, "a") is None
    fake("a", 20, 30)
    assert PS.per_span(ctx, "a", over="b") is None
    assert PS.per_span(ctx, "a") == pytest.approx(10 / 1e6)
    # a program without spans: no import, no reading
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert PS.program_spans(ctx) == []
    assert PS.per_span(ctx, "a") is None


@pytest.mark.parametrize("metric,span,cell", [
    ("tracegen_ms", "api.tracegen", "paper-gpu"),
    ("finalize_ms", "event.finalize", "paper-gpu"),
    ("wave_idle_ms", "wave.step", "paper-gpu"),
    ("admit_idle_ms", "serve.admit", "qwen3-1.7b"),
    ("residency_ms", "serve.residency", "qwen3-1.7b"),
    ("decode_idle_ms", "serve.decode", "qwen3-1.7b"),
])
def test_each_reader_reads_its_span(fake, metric, span, cell):
    ctx = _ctx(0, 1000, [(0, 100, "k"), (400, 1000, "k")])
    fake("api.execute", 0, 900)
    fake("serve.step", 0, 900)
    fake(span, 50, 350)
    got = S.load_reader(metric).read(ctx)
    idle = metric.endswith("_idle_ms")
    assert got == pytest.approx((250 if idle else 300) / 1e6)
