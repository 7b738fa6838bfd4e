"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``c`` is ``workloads/c.json``, a configuration is the file its
entry names, and a per-layer metric ``m`` is ``metrics/m.py``; a later
change adds any of them by adding files and entries only.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Tuple

#: the checkout's root: ``BENCHMARK.json`` and ``perfbench/`` sit here
ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "perfbench"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise ValueError(f"no cell {cell!r} in BENCHMARK.json; cells: "
                     f"{[w['name'] for w in bench['workloads']]}")


def cell_path(cell: str, pkg: Path = PKG) -> Path:
    return pkg / "workloads" / f"{cell}.json"


def load_cell(cell: str, pkg: Path = PKG) -> dict:
    """The cell's own file: its driver, config and traffic parameters."""
    with open(cell_path(cell, pkg)) as f:
        return json.load(f)


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise ValueError(f"no configuration {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    with open(root / config_entry(bench, name)["file"]) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_for(bench: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """The end-to-end and per-layer metrics the cell reports: those that
    list it under ``workloads``, and those without the key (a per-layer
    metric without it goes wherever the metric it moves is reported)."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in names and _applies(m, cell)]
    return e2e, layer


def metric_path(name: str, pkg: Path = PKG) -> Path:
    return pkg / "metrics" / f"{name}.py"


def load_reader(name: str, pkg: Path = PKG) -> ModuleType:
    """The reader module of per-layer metric ``name``: ``MOVES`` (the
    end-to-end metric it should move) and ``read(ctx)`` (a number, or
    None where the run gave it nothing to read)."""
    path = metric_path(name, pkg)
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_layer_metrics(metrics: List[dict], ctx,
                       pkg: Path = PKG) -> Dict[str, dict]:
    """Each metric's reading, with its unit; a reader that returns None
    leaves its metric out."""
    out = {}
    for m in metrics:
        value = load_reader(m["name"], pkg).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
