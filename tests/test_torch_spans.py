"""The program's span recorder (``repro_torch.spans``) and its sites.

Spans record only under a profiler session or ``enable()``; they nest by
their parents, close when their body raises, keep to a bounded buffer
and read the clock of ``time.perf_counter_ns``. The sites' spans count
what the program's own counters count: a cut fig7 experiment's buckets
on the event engine, the wave loop's ``WAVES``, and a 2-layer
``ServeEngine``'s admissions, decode steps and restores; the pool's
``lookups`` count every key its batched and per-key paths look up. The
outputs are bitwise the same with spans on and off.
"""
import collections
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch import spans as SP
from repro_torch.core import baselines as BL
from repro_torch.core import tracegen as TG
from repro_torch.core import workloads as WL
from repro_torch.core.engine import wavefront as WF
from repro_torch.configs.base import get_config
from repro_torch.serving import engine as ENG
from repro_torch.serving.engine import EngineConfig, ServeEngine
from repro_torch.serving.pool import MedicPoolManager, PoolConfig
from repro_torch.serving.request import ServeWorkload, generate_requests


@pytest.fixture(autouse=True)
def recording_off():
    SP.disable()
    yield
    SP.disable()


def _recorded(fn):
    """Run ``fn`` and return the spans that began inside the call."""
    t0 = time.perf_counter_ns()
    out = fn()
    t1 = time.perf_counter_ns()
    return out, [s for s in SP.SPANS.between(t0, t1) if s.t0 >= t0]


def _names(spans):
    return collections.Counter(s.name for s in spans)


def test_off_by_default_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled

    def body():
        with SP.span("off.outer"):
            with SP.span("off.inner", 3):
                pass
    _, got = _recorded(body)
    assert got == []


@pytest.mark.parametrize("how", ["profiler", "enable"])
def test_records_under_a_profiler_or_enable(how):
    def body():
        if how == "enable":
            SP.enable()
            with SP.span("on.one", 7):
                pass
            SP.disable()
        else:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                with SP.span("on.one", 7):
                    pass
        with SP.span("on.after"):
            pass
    _, got = _recorded(body)
    assert [(s.name, s.key, s.raised) for s in got] == [("on.one", 7, False)]


def test_parents_follow_nesting():
    def body():
        SP.enable()
        with SP.span("nest.a"):
            with SP.span("nest.b", 1):
                with SP.span("nest.c", 2):
                    pass
            with SP.span("nest.d"):
                pass
        with SP.span("nest.e"):
            pass
    _, got = _recorded(body)
    by = {s.name: s for s in got}
    assert by["nest.a"].parent == -1 and by["nest.e"].parent == -1
    assert by["nest.b"].parent == by["nest.a"].index
    assert by["nest.c"].parent == by["nest.b"].index
    assert by["nest.d"].parent == by["nest.a"].index
    assert by["nest.a"].t0 <= by["nest.b"].t0 <= by["nest.c"].t0 \
        <= by["nest.c"].t1 <= by["nest.b"].t1 <= by["nest.d"].t0 \
        <= by["nest.d"].t1 <= by["nest.a"].t1


def test_a_span_closes_when_its_body_raises():
    def body():
        SP.enable()
        with pytest.raises(KeyError):
            with SP.span("raise.outer"):
                with SP.span("raise.inner", 5):
                    raise KeyError("x")
        with SP.span("raise.next"):
            pass
    _, got = _recorded(body)
    by = {s.name: s for s in got}
    assert by["raise.inner"].raised and by["raise.outer"].raised
    assert not by["raise.next"].raised
    # the stack unwound: the next span is at the top again
    assert by["raise.next"].parent == -1
    assert by["raise.inner"].parent == by["raise.outer"].index


def test_the_buffer_drops_the_oldest_and_counts_them(monkeypatch):
    buf = SP.SpanBuffer(capacity=3)
    monkeypatch.setattr(SP, "SPANS", buf)
    SP.enable()
    for k in range(5):
        with SP.span("drop", k):
            pass
    assert buf.dropped == 2
    assert [s.key for s in buf.between(0, time.perf_counter_ns())] == \
        [2, 3, 4]


def test_spans_read_the_perf_counter_clock():
    SP.enable()
    a = time.perf_counter_ns()
    with SP.span("clock"):
        b = time.perf_counter_ns()
        time.sleep(0.002)
        c = time.perf_counter_ns()
    d = time.perf_counter_ns()
    (s,) = [s for s in SP.SPANS.between(a, d) if s.name == "clock"]
    assert a <= s.t0 <= b <= c <= s.t1 <= d
    # the window clips by overlap: a window inside the span finds it
    assert s in SP.SPANS.between(b, c)
    assert s not in SP.SPANS.between(d + 1, d + 2)


def test_export_chrome_reads_back(tmp_path):
    SP.enable()
    w0 = time.time_ns()
    a = time.perf_counter_ns()
    with SP.span("chrome.outer", 11):
        with SP.span("chrome.inner"):
            time.sleep(0.001)
    d = time.perf_counter_ns()
    w1 = time.time_ns()
    SP.disable()
    base = w0 - 10**9
    path = tmp_path / "spans.json"
    SP.SPANS.export_chrome(str(path), base_ns=base)
    doc = json.loads(path.read_text())
    assert doc["baseTimeNanoseconds"] == base
    ours = {s.index: s for s in SP.SPANS.between(a, d)}
    events = [e for e in doc["traceEvents"] if e["args"]["index"] in ours]
    assert sorted(e["name"] for e in events) == ["chrome.inner",
                                                 "chrome.outer"]
    for e in events:
        s = ours[e["args"]["index"]]
        assert e["ph"] == "X" and e["args"]["parent"] == s.parent
        assert e["args"]["key"] == s.key
        assert e["dur"] == pytest.approx((s.t1 - s.t0) / 1e3)
        # on the wall clock, from the file's base (a few ms of slack for
        # the two clocks read at different instants)
        wall = base + e["ts"] * 1e3
        assert w0 - 5e6 <= wall <= w1 + 5e6


# ---------------------------------------------------------------------------
# the sites against the program's counters
# ---------------------------------------------------------------------------

CUT = dict(n_warps=6, n_instr=4)


def _fig7_cut(engine):
    """fig7's policies over the quick workloads cut to 6 warps x 4
    instructions (one bucket), on the CPU."""
    scen = tuple(api.Scenario.from_spec(dataclasses.replace(
        TG.TraceSpec.from_workload(WL.WORKLOADS[n]), **CUT), seeds=(0,))
        for n in api.registry.QUICK_WORKLOADS)
    return api.registry.PAPER_FIG7_QUICK.with_(
        scenarios=scen, engine=engine, device="cpu")


def _outputs(rs):
    return [{k: np.asarray(v) for k, v in rs.get(scenario=name,
                                                  seed=0).items()}
            for name in rs.scenarios]


def _same_outputs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_experiment_spans_follow_its_buckets_and_change_nothing():
    exp = _fig7_cut("event")
    off = exp.run()
    SP.enable()
    on, got = _recorded(exp.run)
    SP.disable()
    _same_outputs(_outputs(off), _outputs(on))
    n = exp.compile().n_calls
    assert n == 1
    assert _names(got) == {"api.run": 1, "api.compile": 1, "api.execute": 1,
                           "api.tracegen": n, "api.simulate": n,
                           "api.results": n, "event.loop": n,
                           "event.finalize": n}
    by = {s.name: s for s in got}
    assert by["api.compile"].parent == by["api.run"].index
    assert by["api.execute"].parent == by["api.run"].index
    for name in ("api.tracegen", "api.simulate", "api.results"):
        assert by[name].parent == by["api.execute"].index
        assert by[name].key == 0
    for name in ("event.loop", "event.finalize"):
        assert by[name].parent == by["api.simulate"].index
    assert by["api.tracegen"].t1 <= by["api.simulate"].t0 \
        <= by["api.simulate"].t1 <= by["api.results"].t0


def test_wave_spans_count_the_waves_and_change_nothing():
    exp = _fig7_cut("wavefront").with_(policies=(BL.BASELINE, BL.MEDIC))
    off = exp.run()
    SP.enable()
    w0 = WF.WAVES.waves
    on, got = _recorded(exp.run)
    waves = WF.WAVES.waves - w0
    SP.disable()
    _same_outputs(_outputs(off), _outputs(on))
    steps = [s for s in got if s.name == "wave.step"]
    pend = [s for s in got if s.name == "wave.pending"]
    assert waves > 0 and len(steps) == len(pend) == waves
    idx = {s.index: s for s in steps}
    for p in pend:
        # each exit test is inside its wave, keyed by the wave after it
        assert idx[p.parent].key + 1 == p.key
    sims = [s for s in steps if s.key == 0]
    # one simulation a policy and trace
    assert len(sims) == len(exp.policies) * len(exp.scenarios)
    assert {s.name for s in got if s.index in {x.parent for x in steps}} \
        == {"api.simulate"}


def _serve(policy="medic"):
    cfg = get_config("qwen3_1_7b").reduced(
        num_layers=2, d_model=32, num_heads=2, num_kv_heads=1, head_dim=16,
        d_ff=48, vocab_size=300)
    eng = ServeEngine(cfg, EngineConfig(max_slots=2, max_len=448),
                      PoolConfig(budget_blocks=12, block_tokens=16,
                                 sampling_interval=8, policy=policy),
                      device="cpu")
    keys = [0]
    access = eng.pool.access

    def counted(slot, blocks, now, resident_key=None):
        keys[0] += len(blocks)
        return access(slot, blocks, now, resident_key=resident_key)
    eng.pool.access = counted
    reqs = generate_requests(ServeWorkload(
        n_requests=6, chat_frac=0.5, rag_prompt=(64, 160), decode=(8, 24),
        arrival_rate=1.0), seed=3)
    ENG.COUNTS.reset()
    snap = eng.run(reqs, max_steps=300)
    return eng, snap, dataclasses.replace(ENG.COUNTS), keys[0]


def test_serve_spans_count_the_engine_and_change_nothing():
    _, off, _, _ = _serve()
    SP.enable()
    (eng, on, counts, keys), got = _recorded(_serve)
    SP.disable()
    assert off.keys() == on.keys()
    for k in off:
        x, y = off[k], on[k]
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y or (x != x and y != y), k
    n = _names(got)
    assert counts.admissions >= 3 and counts.restores > 0
    assert n["serve.step"] == n["serve.residency"] == on["steps"]
    assert n["serve.admit"] == n["serve.prefill"] == n["serve.merge"] == \
        n["serve.pool_insert"] == counts.admissions
    assert n["serve.decode"] == n["serve.stream_out"] == counts.decode_steps
    assert n["serve.restore"] == counts.restores
    idx = {s.index: s for s in got}
    for s in got:
        parent = idx[s.parent].name if s.parent >= 0 else None
        assert parent == {"serve.step": None, "serve.prefill": "serve.admit",
                          "serve.merge": "serve.admit",
                          "serve.pool_insert": "serve.admit",
                          "serve.restore": "serve.residency"}.get(
                              s.name, "serve.step"), s
        if parent == "serve.admit":        # a request's spans share its id
            assert s.key == idx[s.parent].key >= 0
    assert eng.pool.lookups == keys > eng.pool.fetches > 0


def test_pool_lookups_count_both_paths_alike():
    """``access_batch`` (vectorized all-hit runs, per-key misses) and the
    per-key calls it stands for count the same lookups, every key once."""
    rng = np.random.default_rng(5)
    cfg = PoolConfig(budget_blocks=6, block_tokens=16, sampling_interval=4)
    a, b = MedicPoolManager(cfg, 6), MedicPoolManager(cfg, 6)
    total = 0
    for step in range(60):
        owner = np.sort(rng.integers(0, 4, rng.integers(1, 10)))
        kslot = owner.copy()
        shared = rng.random(owner.size) < 0.25
        kslot[shared] = 4 + rng.integers(0, 2, shared.sum())
        kblk = rng.integers(0, 4, owner.size)
        a.access_batch(owner, kslot, kblk, float(step))
        for q in range(owner.size):
            b.access(int(owner[q]), [int(kblk[q])], float(step),
                     resident_key=(int(kslot[q]), int(kblk[q])))
        total += owner.size
    assert a.lookups == b.lookups == total
    assert a.fetches == b.fetches
    assert 0 < a.fetches < a.lookups


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_record_under_a_cuda_only_profiler(cuda_device):
    """The benchmark's profiler mode: CUDA activity alone."""
    def body():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            with SP.span("cuda.one", 2):
                torch.ones(8, device=cuda_device).add_(1)
                torch.cuda.synchronize()
    _, got = _recorded(body)
    assert [(s.name, s.key) for s in got] == [("cuda.one", 2)]
