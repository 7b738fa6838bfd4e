"""``BENCHMARK.json`` against the files it names and the rules it keeps:
every cell, configuration and per-layer metric resolves by name; names,
units and entries stay within their limits; a new cell, configuration or
metric needs files only; nothing under ``perfbench/`` imports JAX or the
JAX package; a run without a CUDA device prints nothing."""
from __future__ import annotations

import ast
import dataclasses
import importlib
import json

import pytest

from perfbench.harness import cli
from perfbench.harness import spec as S

BENCH = S.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
LAYER = [m["name"] for m in BENCH["per_layer"]]
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_keep_their_keys_and_names(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) <= ENTRY_KEYS[section], e
        assert S.NAME_RE.match(e["name"]), e["name"]
        if "unit" in e:
            assert S.UNIT_RE.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k], e[k]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    entry = S.cell_entry(BENCH, cell)
    own = S.load_cell(cell)
    assert own["config"] == entry["config"]
    assert own["traffic"] == entry["traffic"]
    assert S.NAME_RE.match(entry["traffic"])
    assert entry["chips"] == 1
    importlib.import_module(f"perfbench.drivers.{own['driver']}")
    S.load_config(BENCH, entry["config"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_e2e_and_a_layer_metric(cell):
    e2e, layer = S.metrics_for(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer


def test_configs_are_used_and_their_files_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/")
        assert json.loads((S.ROOT / c["file"]).read_text())["name"] == \
            c["name"]


@pytest.mark.parametrize("metric", LAYER)
def test_layer_metric_resolves_and_moves_a_reported_metric(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    reader = S.load_reader(metric)
    assert reader.MOVES == entry["moves"] and callable(reader.read)
    assert entry["moves"] in E2E
    for cell in entry.get("workloads", []):
        assert cell in CELLS
        names = {m["name"] for m in S.metrics_for(BENCH, cell)[0]}
        assert entry["moves"] in names


def test_end_to_end_metrics_and_bounds():
    assert set(E2E) == {"setup_s", "sim_req_s", "serve_tok_s", "itl_p95_ms",
                        "ttft_p95_ms"}
    for m in E2E.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "workloads" not in E2E["setup_s"]


def test_a_cell_config_and_metric_need_files_only(tmp_path):
    """A new configuration, cell and per-layer metric added as files and
    entries, with no code changed, are found by their names."""
    pkg = tmp_path / "perfbench"
    for d in ("workloads", "metrics", "configs"):
        (pkg / d).mkdir(parents=True)
    (pkg / "configs" / "cfg-x.json").write_text('{"name": "cfg-x"}')
    (pkg / "workloads" / "cfg-x.mix.json").write_text(json.dumps(
        {"driver": "serve", "config": "cfg-x", "traffic": "mix"}))
    (pkg / "metrics" / "x_share.y.py").write_text(
        'MOVES = "serve_tok_s"\n\ndef read(ctx):\n    return ctx["x"]\n')
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "cfg-x", "source": "s",
                             "file": "perfbench/configs/cfg-x.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "cfg-x.mix", "config": "cfg-x",
                               "traffic": "mix", "chips": 1, "why": "w"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "serve_tok_s":
            m["workloads"].append("cfg-x.mix")
    bench["per_layer"].append({"name": "x_share.y", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "x", "moves": "serve_tok_s",
                               "workloads": ["cfg-x.mix"]})
    assert S.load_cell("cfg-x.mix", pkg)["config"] == "cfg-x"
    assert S.load_config(bench, "cfg-x", tmp_path) == {"name": "cfg-x"}
    e2e, layer = S.metrics_for(bench, "cfg-x.mix")
    assert [m["name"] for m in layer] == ["x_share.y"]
    assert [m["name"] for m in e2e] == ["setup_s", "serve_tok_s"]
    got = S.read_layer_metrics(layer, {"x": 41.5}, pkg)
    assert got == {"x_share.y": {"value": 41.5, "unit": "%"}}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level module names compared whole: ``repro_torch`` is the
    program, ``repro`` the JAX package."""
    old_scripts = "bench" + "marks"     # the JAX-era scripts' folder
    files = sorted(S.PKG.rglob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in cli.FORBIDDEN + (old_scripts,), (path, name)
        assert old_scripts + "/" not in path.read_text(), path


def test_forbidden_modules_compares_whole_names():
    names = ["repro_torch", "repro_torch.api", "jaxtyping", "numpy"]
    assert cli.forbidden_modules(names) == []
    assert cli.forbidden_modules(names + ["repro.core", "jax.numpy"]) == \
        ["jax", "repro"]


def test_no_result_without_a_cuda_device(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["--workload", CELLS[0], "--seed", "3000000000",
                   "--seconds", "1", "--trace", "0"], 0.0)
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_paper_gpu_config_is_what_the_program_runs():
    from repro_torch.api import registry as REG
    from repro_torch.core import workloads as WL
    from repro_torch.core.engine import SimParams
    cfg = S.load_config(BENCH, "paper-gpu")
    assert SimParams(**cfg["sim_params"]) == SimParams()
    assert [p["name"] for p in cfg["fig7_policies"]] == \
        [p.name for p in REG.FIG7_SWEEP_POLICIES]
    for p, q in zip(cfg["fig7_policies"], REG.FIG7_SWEEP_POLICIES):
        assert {k: v for k, v in p.items() if k != "name"} == \
            {k: getattr(q, k) for k in p if k != "name"}
    for name, w in WL.WORKLOADS.items():
        got = {k: list(v) if isinstance(v, tuple) else v
               for k, v in dataclasses.asdict(w).items() if k != "name"}
        assert cfg["workloads"][name] == got


def test_qwen3_config_is_the_programs_qwen3():
    from perfbench.drivers.serve import model_config
    from repro_torch.configs.base import get_config
    got = model_config(S.load_config(BENCH, "qwen3-1.7b"))
    want = get_config("qwen3_1_7b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "qk_norm", "rope_theta",
              "tie_embeddings", "norm_eps", "dtype", "qkv_bias", "act"):
        assert getattr(got, f) == getattr(want, f), f
