"""The program's spans (``repro_torch.spans``) in a benchmark cell's traced
window, held against the program's counters, on one NVIDIA card.

    python3 tools/chip_spans.py --workload <cell> --seed <n> \\
        [--seconds 51] [--out FILE]
    python3 tools/chip_spans.py --cost
    python3 tools/chip_spans.py --identity

The first form runs the cell as ``perfbench/run.py --trace 1`` does (the
same ``perfbench/drivers`` code, window and result line, printed first)
and then reads the window's program spans:

  * ``span_counts``: the spans of each name that began in the window and
    closed, and those whose body raised (the window's close);
  * ``deltas``: the program's counters over the profiler's window
    (``WAVES``; ``COUNTS``'s admissions, decode steps and restores; the
    pool's ``lookups`` and ``fetches``), read as the profiler starts and
    stops, and ``matches``: each count against its delta. The serving
    window opens inside an admission or a decode step (``opened_in``),
    which began before spans recorded and so has none: it is added to
    its count. ``pool_hit_pct_from_lookups`` is ``(lookups - fetches) /
    lookups`` over the same window, beside the result line's
    ``pool_hit_pct``;
  * ``idle``: the window's device-idle seconds, those inside some
    program span below the top level (every name but ``api.run`` and
    ``serve.step``) and their share, and the idle seconds inside each
    span name (a span's idle counts for its parents too);
  * ``spans_per_s`` and the buffer's ``dropped``.

``--cost`` times ``span`` on this host, off and on (ns a site, over
200,000 calls). ``--identity`` runs fig7's quick experiment on both
engines and a 2-layer Qwen3-1.7B ``ServeEngine`` on the card with spans
off and on, and compares the outputs and the snapshot bit for bit.

Prints one JSON line per part (the card's name and power limit in
each); ``--out`` also writes the traced run's line and analysis, with
every span of the window, to a file.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# the cache directories of perfbench/run.py
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" /
                                                  "torch_ext"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

#: spans at the top of their cell's window: coverage counts those below
TOP = ("api.run", "serve.step")


def card() -> dict:
    import torch
    out = {"device": torch.cuda.get_device_name(0)
           if torch.cuda.is_available() else "cpu"}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = None
    return out


def _watch():
    """Snapshots of the program's counters as the profiler starts and
    stops, and the benchmark wrapper the window opened in."""
    from perfbench.harness import trace as TR
    from repro_torch.core.engine import wavefront as WF
    from repro_torch.serving import engine as ENG
    last, marks = [lambda: None], {}
    init = ENG.ServeEngine.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        # weakly: the serving cell frees its warm-up engine before the window
        last[0] = weakref.ref(self)
    ENG.ServeEngine.__init__ = keep

    def snap():
        d = dict(waves=WF.WAVES.waves, admissions=ENG.COUNTS.admissions,
                 decode_steps=ENG.COUNTS.decode_steps,
                 restores=ENG.COUNTS.restores)
        eng = last[0]()
        if eng is not None:
            d.update(lookups=eng.pool.lookups, fetches=eng.pool.fetches)
        return d

    def opened_in():
        f = sys._getframe()
        while f is not None:
            if f.f_code.co_filename.endswith("drivers/serve.py") and \
                    f.f_code.co_name in ("admit", "decode_step"):
                return f.f_code.co_name
            f = f.f_back
        return None
    start, stop = TR.DeviceTrace.start, TR.DeviceTrace.stop

    def on_start(self):
        marks["start"], marks["opened_in"] = snap(), opened_in()
        start(self)

    def on_stop(self):
        s = stop(self)
        marks["stop"] = snap()
        return s
    TR.DeviceTrace.start, TR.DeviceTrace.stop = on_start, on_stop
    return marks


def analyse(ctx, marks: dict, line: dict) -> dict:
    """Counts, deltas and idle coverage of the window's program spans."""
    from perfbench.metrics import _program_spans as PS
    from repro_torch.spans import SPANS
    t0, t1 = ctx.trace.t0_ns, ctx.trace.t1_ns
    spans = PS.program_spans(ctx)
    began = [s for s in spans if s.t0 >= t0]
    counts, raised = {}, {}
    for s in began:
        d = raised if s.raised else counts
        d[s.name] = d.get(s.name, 0) + 1
    delta = {k: marks["stop"][k] - marks["start"][k] for k in marks["stop"]}
    opened = marks.get("opened_in")
    want = {"wave.step": "waves", "serve.admit": "admissions",
            "serve.decode": "decode_steps", "serve.restore": "restores"}
    matches = {}
    for name, key in want.items():
        if not delta.get(key):
            continue
        n = counts.get(name, 0) + int(
            (name, opened) in (("serve.admit", "admit"),
                               ("serve.decode", "decode_step")))
        matches[name] = [n, delta[key], n == delta[key]]
    out = {"span_counts": counts, "raised": raised, "deltas": delta,
           "opened_in": opened, "matches": matches}
    if delta.get("lookups"):
        hit = 100.0 * (delta["lookups"] - delta["fetches"]) / \
            delta["lookups"]
        got = line["metrics"].get("pool_hit_pct", {}).get("value")
        out["pool_hit_pct_from_lookups"] = [hit, got, hit == got]
    idle = sum(b - a for a, b in ctx.trace.gaps)
    below = [(max(s.t0, t0), min(s.t1, t1)) for s in spans
             if s.name not in TOP]
    names = sorted({s.name for s in spans})
    out["idle"] = {
        "window_s": ctx.trace.window_s, "idle_s": idle / 1e9,
        "below_top_s": PS.idle_ns(ctx, below) / 1e9,
        "below_top_share": PS.idle_ns(ctx, below) / idle if idle else None,
        "by_span_s": {n: PS.idle_ns(ctx, [(max(s.t0, t0), min(s.t1, t1))
                                          for s in spans if s.name == n])
                      / 1e9 for n in names}}
    out["spans_per_s"] = len(spans) / ctx.trace.window_s
    out["dropped"] = SPANS.dropped
    return out


def traced(args) -> None:
    import torch
    from perfbench.harness import cli
    from perfbench.harness import spec as S
    from perfbench.harness.run import RunContext
    from perfbench.reference import peaks
    t_start = time.perf_counter()
    marks = _watch()
    bench = S.load_benchmark()
    entry = S.cell_entry(bench, args.workload)
    rc = RunContext(args.workload, S.load_cell(args.workload),
                    S.load_config(bench, entry["config"]), args.seed,
                    args.seconds, True, "cuda" if torch.cuda.is_available()
                    else "cpu", t_start)
    res = cli.execute(rc)
    line = cli.result_line(bench, args.workload, entry["chips"], res, True,
                           card()["device"],
                           {"power_limit_w": peaks.power_limit_w()})
    print(json.dumps(line), flush=True)
    got = {"workload": args.workload, "seed": args.seed, **card(),
           **analyse(res.layer, marks, line)}
    print(json.dumps(got), flush=True)
    if args.out:
        from perfbench.metrics import _program_spans as PS
        spans = [list(s) for s in PS.program_spans(res.layer)]
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"line": line, "analysis": got, "window": [
                res.layer.trace.t0_ns, res.layer.trace.t1_ns],
             "spans": spans}))


def cost() -> None:
    from repro_torch import spans as SP
    n = 200_000

    def run():
        t = time.perf_counter_ns()
        for i in range(n):
            with SP.span("cost", i):
                pass
        return (time.perf_counter_ns() - t) / n

    def bare():
        t = time.perf_counter_ns()
        for i in range(n):
            pass
        return (time.perf_counter_ns() - t) / n
    out = {"loop_ns": bare(), "off_ns": run()}
    SP.enable()
    out["on_ns"] = run()
    SP.disable()
    out["off_ns_again"] = run()
    print(json.dumps({"cost": out, **card()}), flush=True)


def identity() -> None:
    import numpy as np
    import torch
    from repro_torch import spans as SP
    from repro_torch.api import registry as REG
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    from repro_torch.serving.pool import PoolConfig
    from repro_torch.serving.request import ServeWorkload, generate_requests
    _build.build_all(["event_loop", "wave_cache", "wave_queue",
                      "flash_attention", "decode_attention", "medic_gather"])

    def sim(engine):
        rs = REG.PAPER_FIG7_QUICK.with_(engine=engine).run()
        return {(n, k): np.asarray(v) for n in rs.scenarios
                for k, v in rs.get(scenario=n, seed=0).items()}

    def serve():
        cfg = get_config("qwen3_1_7b").reduced(num_layers=2)
        eng = ServeEngine(cfg, EngineConfig(max_slots=4, max_len=448),
                          PoolConfig(budget_blocks=48, block_tokens=16))
        snap = eng.run(generate_requests(ServeWorkload(n_requests=12),
                                         seed=0), max_steps=400)
        return {k: np.asarray(v) for k, v in snap.items()}

    def same(a, b):
        return a.keys() == b.keys() and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k],
                                                        equal_nan=True)
            for k in a)
    out = {}
    for name, fn in (("fig7_quick_event", lambda: sim("event")),
                     ("fig7_quick_wavefront", lambda: sim("wavefront")),
                     ("serve_2_layers", serve)):
        off = fn()
        SP.enable()
        t0 = time.perf_counter_ns()
        on = fn()
        SP.disable()
        torch.cuda.synchronize()
        out[name] = {"bitwise": same(off, on), "spans": len(
            SP.SPANS.between(t0, time.perf_counter_ns()))}
    print(json.dumps({"identity": out, **card()}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/chip_spans.py")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=2147483659)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out")
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--identity", action="store_true")
    args = ap.parse_args(argv)
    if args.cost:
        cost()
    if args.identity:
        identity()
    if args.workload:
        traced(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
