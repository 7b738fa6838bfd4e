"""The command: one run of one cell, one JSON line.

``main`` refuses to run without the CUDA devices the cell asks for, runs
the cell's driver, refuses to print a result if JAX or the JAX package
was loaded, and prints the result line: the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics, the device's busy time and the
breakdown (``--trace 1``), then each number compared with its limit, on
standard error too.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from typing import List, Optional

from perfbench.harness import spec as S
from perfbench.harness.run import RunContext, RunResult
from perfbench.harness.trace import breakdown
from perfbench.reference import peaks

#: top-level modules that may not be loaded in the process that prints a
#: result: JAX, its libraries and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the
    modules loaded in this process), compared whole."""
    names = list(sys.modules) if names is None else names
    tops = {name.split(".")[0] for name in names}
    return sorted(tops & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(rc: RunContext) -> RunResult:
    """Run the cell's driver (no device check: the tests drive it on the
    CPU through this)."""
    driver = importlib.import_module(f"perfbench.drivers.{rc.cell['driver']}")
    return driver.run(rc)


def result_line(bench: dict, cell: str, chips: int, res: RunResult,
                trace: bool, kind: str, notes: Optional[dict] = None
                ) -> dict:
    e2e, layer = S.metrics_for(bench, cell)
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": res.memory_peak_bytes}
    line = {"correct": res.correct, "attempted": res.attempted,
            "failed": res.failed}
    if trace:
        line["metrics"] = S.read_layer_metrics(layer, res.layer)
        device["busy_s"] = res.layer.trace.busy_s
        device["window_s"] = res.layer.trace.window_s
    else:
        line["metrics"] = {m["name"]: {"value": float(res.e2e[m["name"]]),
                                       "unit": m["unit"]} for m in e2e}
    line["device"] = device
    if trace:
        line["breakdown"] = breakdown(res.layer.trace, res.layer.spans)
    line["notes"] = {**res.notes, **(notes or {})}
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in res.checks}
    return line


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = S.load_benchmark()
    entry = S.cell_entry(bench, args.workload)
    cell = S.load_cell(args.workload)
    config = S.load_config(bench, entry["config"])
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"perfbench: cell {args.workload} needs {entry['chips']} "
              "CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              , file=sys.stderr)
        return 2
    rc = RunContext(args.workload, cell, config, args.seed, args.seconds,
                    bool(args.trace), "cuda", t_start)
    res = execute(rc)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    line = result_line(bench, args.workload, entry["chips"], res,
                       bool(args.trace), torch.cuda.get_device_name(0),
                       {"power_limit_w": peaks.power_limit_w()})
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
