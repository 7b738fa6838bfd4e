"""The yardstick's arithmetic: rates over all the work and all the time of
a window, tails over all samples, the trace's busy time and gaps, the
roofline counts against hand-worked shapes, the traffic's fixed sizes,
and readers that find nothing returning nothing."""
from __future__ import annotations

import types

import numpy as np
import pytest

from perfbench.drivers import serve as SV
from perfbench.drivers import sim_sweep as SIM
from perfbench.harness import spec as S
from perfbench.harness.stats import p95, percentile
from perfbench.harness.trace import Spans, breakdown, summarize
from perfbench.reference import counts, peaks
from perfbench.reference import traffic as T

MS = 1_000_000


def _steps(gaps_ms, rows=(0,), t0=0):
    """Decode steps ending at the running sums of ``gaps_ms``."""
    out, t = [], t0
    for g in gaps_ms:
        t += g * MS
        out.append((t - MS, t, list(rows), [0] * len(rows)))
    return out


def test_rate_counts_all_work_over_all_the_window():
    steps = _steps([10] * 100, rows=(0, 1))
    e2e, tally = SV.window_metrics(steps, {0: 0, 1: 0}, 0, 2000 * MS)
    assert tally["tokens"] == 200
    # the window's idle second after the last step counts in the rate
    assert e2e["serve_tok_s"] == pytest.approx(200 / 2.0)


def test_a_stall_in_the_window_moves_the_token_gap_tail():
    steady, _ = SV.window_metrics(_steps([10] * 100), {0: 0}, 0, 1000 * MS)
    assert steady["itl_p95_ms"] == pytest.approx(10)
    gaps = [10] * 100
    for k in range(0, 100, 10):        # a stall every tenth step
        gaps[k] = 100
    stalled, _ = SV.window_metrics(_steps(gaps), {0: 0}, 0, 2000 * MS)
    assert stalled["itl_p95_ms"] == pytest.approx(100)


def test_first_token_time_runs_from_admission_over_every_request():
    steps = [(0, 30 * MS, [5, -1], [0, 0]), (30 * MS, 50 * MS, [5, 6],
                                              [0, 0])]
    e2e, tally = SV.window_metrics(steps, {5: 10 * MS, 6: 40 * MS}, 0,
                                   50 * MS)
    assert tally["ttft_samples"] == 2
    assert e2e["ttft_p95_ms"] == pytest.approx(20)     # max of 20, 10


def test_percentile_is_nearest_rank():
    vals = list(range(1, 101))
    assert percentile(vals, 95) == 95
    assert p95([3.0]) == 3.0
    with pytest.raises(ValueError):
        p95([])


def test_trace_summary_busy_union_and_gaps():
    # device clock 7 ns ahead of the host's; two overlapping kernels
    ev = [(12, 15, "a"), (13, 19, "b"), (37, 38, "a"), (60, 70, "c")]
    s = summarize(ev, 7, 0, 50)
    assert s.busy_s == pytest.approx(8e-9)
    assert s.gaps == [(0, 5), (12, 30), (31, 50)]
    assert s.kernel("a") == (pytest.approx(4e-9), 2)
    assert s.window_s == pytest.approx(50e-9)


def test_breakdown_names_ops_and_the_host_spans_over_gaps():
    sp = Spans()
    sp.items = [("outer", 0, 100), ("inner", 10, 20), ("late", 90, 200)]
    assert sp.labels_at([15, 25, 95, 250]) == ["inner", "outer", "late",
                                               None]
    s = summarize([(5, 8, "k1"), (6, 12, "k2"), (30, 31, "k1")], 0, 0, 50)
    b = breakdown(s, sp)
    assert [n for n, _ in b["device_ops"]] == ["k2", "k1"]
    # gaps (0, 5), (12, 30) and (31, 50) all fall inside "outer" only
    assert dict(b["idle_gaps"]) == {"outer": pytest.approx(4.2e-8)}


def test_decode_attention_counts_by_hand():
    c = counts.decode_attention([10, 20], heads=16, kv_heads=8, head_dim=128)
    assert c["ops"] == 4 * 30 * 16 * 128
    assert c["bytes"] == 2 * 30 * 8 * 128 * 2 + 2 * 2 * 16 * 128 * 2 + 2 * 2 * 4


def test_flash_attention_counts_by_hand():
    c = counts.flash_attention(4, heads=2, kv_heads=1, head_dim=8)
    assert c["ops"] == 4 * 10 * 2 * 8              # 10 causal pairs
    assert c["bytes"] == (2 * 4 * 2 + 2 * 4 * 1) * 8 * 2
    assert counts.flash_attention(4, 2, 1, 8, causal=False)["ops"] == \
        4 * 16 * 2 * 8


def test_event_loop_counts_by_hand():
    prm = dict(sets=2, ways=2, banks=1, dram_channels=1, eaf_bits=4,
               pc_entries=2)
    c = counts.event_loop(1, 2, 3, 4, 2, prm)
    assert set(c) == {"bytes"}             # the byte bound alone
    inputs = 2 * 3 * 4 * 4 + 2 * 6 * 4 + 2 * 4 + 2 * 16 * 4 + 2 * 3
    state = (3 * 4 * 4 + 4 + 3 * 4 + 4 * 4 + 8 + 3 * 2 * 4 + 8 * 3 * 4
             + 23 * 4)
    assert c["bytes"] == inputs + 2 * (state + 2 * 3 * 4 + 2 * 3 * 4)


def test_wave_pass_counts_by_hand():
    prm = dict(sets=2, ways=2, eaf_bits=4, pc_entries=2, banks=1,
               dram_channels=2)
    c = counts.wave_cache(3, 2, prm)
    state = 3 * 4 * 4 + 4 * 4 + 8 + 3 * 2 * 4
    inputs = state + 3 * 24 + 3 * (2 * 4 + 12 + 2) + 64
    outputs = state + 3 * 24 + 3 * 2 * (12 + 6)
    assert c == {"bytes": float(inputs + outputs)}
    q = counts.wave_queue(5, prm)
    assert q == {"bytes": float(5 * 20 + 5 * 9 + 2 * (2 + 14) * 4)}


def test_a_share_without_operations_is_of_the_byte_bound():
    assert peaks.least_time(0.0, peaks.HBM_BYTES_PER_S, None) == \
        (1.0, "memory")


def test_model_flops_by_hand():
    cfg = dict(hidden_size=4, head_dim=2, num_attention_heads=2,
               num_key_value_heads=1, intermediate_size=8,
               num_hidden_layers=3, vocab_size=10)
    per_layer = 4 * 4 * 2 + 2 * 2 * 4 + 3 * 4 * 8
    assert counts.dense_linear_params(cfg) == 3 * per_layer
    lin, head = 2 * 3 * per_layer, 2 * 4 * 10
    want = (5 * lin + head + 3 * 4 * 2 * 2 * 15) \
        + (lin + head + 3 * 4 * 2 * 2 * 8)
    assert counts.model_flops(cfg, [5], [7]) == pytest.approx(want)


def test_least_time_names_its_bound():
    assert peaks.least_time(1e12, 1.0, 1e12) == (1.0, "compute")
    assert peaks.least_time(1.0, peaks.HBM_BYTES_PER_S, 1e12) == \
        (1.0, "memory")


def test_roofline_share_sums_least_times_over_device_time():
    from perfbench.metrics._common import share
    trace = summarize([(0, 2 * MS, "my_kernel<1>"), (3 * MS, 5 * MS,
                                                     "other")], 0, 0, 6 * MS)
    ctx = types.SimpleNamespace(trace=trace)
    calls = [{"ops": 1e9, "bytes": 0.0, "n": 2}]
    # 2 launches of 1 GFLOP at 1 TFLOP/s: 2 ms least over 2 ms measured
    assert share(ctx, ["my_kernel"], calls, 1e12) == pytest.approx(100)
    assert share(ctx, ["absent"], calls, 1e12) is None


def _empty_ctx():
    return types.SimpleNamespace(
        trace=summarize([], 0, 0, 0), spans=Spans(), counts={},
        calls={"sweep": [], "wave": [(16384, 16)], "policies": [4],
               "decode": [],
               "decode_active": [], "prefill": []},
        config=S.load_config(S.load_benchmark(), "qwen3-1.7b"))


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    S.load_benchmark()["per_layer"]])
def test_a_reader_that_finds_nothing_returns_nothing(metric):
    ctx = _empty_ctx()
    if metric in ("event_loop_roofline_pct", "wave_cache_roofline_pct",
                  "wave_queue_roofline_pct"):
        ctx.config = S.load_config(S.load_benchmark(), "paper-gpu")
    assert S.load_reader(metric).read(ctx) is None


def test_traffic_serves_the_same_sizes_for_every_seed():
    mix = S.load_cell("qwen3-1.7b.serve-mix")["mix"]
    a, b = T.generate(mix, 2147483659), T.generate(mix, 3000000001)
    assert a == T.generate(mix, 2147483659)
    assert [r.prompt_len for r in a] != [r.prompt_len for r in b]
    deck = mix["deck"]
    for k in range(0, 4 * deck, deck):
        key = lambda r: (r.prompt_len, r.decode_len, r.shared_prefix_id)  # noqa: E731
        assert sorted(map(key, a[k:k + deck])) == \
            sorted(map(key, b[k:k + deck]))
    assert [r.arrival for r in a] == [r.arrival for r in b]


def test_log_normal_lengths_keep_their_median_and_the_context():
    mix = S.load_cell("qwen3-1.7b.serve-longprompt")["mix"]
    cards = T.deck(mix)
    prompt = np.array([c["prompt_len"] for c in cards])
    decode = np.array([c["decode_len"] for c in cards])
    assert np.median(prompt) == mix["rag_prompt"]["median"]
    assert np.median(decode) == mix["decode"]["median"]
    # a heavy tail: the mean well above the median, the top past 5x it
    assert prompt.mean() > 1.25 * np.median(prompt)
    assert decode.mean() > 1.8 * np.median(decode)
    assert decode.max() > 10 * np.median(decode)
    assert (prompt + decode).max() <= mix["max_context"]
    assert (decode >= 1).all() and (prompt >= 1).all()
    # the deck's quantiles follow the log-normal: about 16 % above
    # median x exp(sigma)
    sigma = np.sqrt(2 * np.log(mix["decode"]["mean"] / mix["decode"]["median"]))
    share = (decode > mix["decode"]["median"] * np.exp(sigma)).mean()
    assert abs(share - 0.1587) < 0.01


def test_trace_seeds_are_fresh_and_fixed():
    seeds = [SIM.trace_seed(2 ** 31 + 11, k) for k in range(-1, 50)]
    assert len(set(seeds)) == len(seeds)
    assert all(0 <= s < 2 ** 31 for s in seeds)
    assert seeds == [SIM.trace_seed(2 ** 31 + 11, k) for k in range(-1, 50)]
