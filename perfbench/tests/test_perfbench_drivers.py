"""Whole runs of both drivers on the CPU at a tiny size, past the
harness's look for a chip: a sound run comes out correct, and a run with
the timed path broken underneath comes out not correct, once for each
fault the cells can have: a step that returns its state unchanged, half
of the batch left out, an answer altered where it is produced. (No cell
spans chips, so none can lose an exchange between them.)"""
from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

from perfbench.harness import cli
from perfbench.harness import spec as S
from perfbench.harness.run import RunContext
from perfbench.reference import event_sim as ES

BENCH = S.load_benchmark()
SIM_CELL = "paper-gpu.fig7-event"
SERVE_CELL = "qwen3-1.7b.serve-longprompt"
CUT = dict(n_warps=8, n_instr=3, lines_per_instr=4)


@pytest.fixture
def sim_rc(monkeypatch):
    from repro_torch.core import workloads as WL
    cell = copy.deepcopy(S.load_cell(SIM_CELL))
    config = copy.deepcopy(S.load_config(BENCH, "paper-gpu"))
    for name, w in list(WL.WORKLOADS.items()):
        monkeypatch.setitem(WL.WORKLOADS, name,
                            dataclasses.replace(w, **CUT))
        config["workloads"][name].update(CUT)
    cell["check"]["per_policy"] = 4
    return RunContext(SIM_CELL, cell, config, 3000000017, 0.3, False, "cpu",
                      time.perf_counter())


def test_sim_run_is_correct(sim_rc):
    res = cli.execute(sim_rc)
    assert res.correct, res.checks
    assert res.e2e["sim_req_s"] > 0 and res.attempted >= 165
    line = cli.result_line(BENCH, SIM_CELL, 1, res, False, "cpu")
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"setup_s", "sim_req_s"}


def _unchanged(out):
    return {k: torch.zeros_like(v) for k, v in out.items()}


def _half_batch(out):
    """The second half of the stacked traces left out: their outputs are
    copies of the first half's."""
    res = {}
    for k, v in out.items():
        v = v.clone()
        f = v.shape[1]
        v[:, f - f // 2:] = v[:, :f // 2]
        res[k] = v
    return res


def _altered(out):
    res = dict(out)
    res["l2_hits"] = out["l2_hits"] + 1
    return res


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
def test_sim_run_with_a_fault_is_not_correct(sim_rc, monkeypatch, fault):
    from repro_torch.api import experiment as EXP
    real = EXP.simulate_sweep
    monkeypatch.setattr(EXP, "simulate_sweep",
                        lambda *a, **k: fault(real(*a, **k)))
    assert not cli.execute(sim_rc).correct


@pytest.mark.parametrize("per_policy", [1, 3])
def test_the_check_samples_every_policy(per_policy):
    pols = [f"p{k}" for k in range(11)]
    names = ["BFS", "BP", "CONS"]
    got = ES.sample_sims(np.random.default_rng(2 ** 31 + 5), 2, names,
                         pols, per_policy)
    assert len(got) == len(set(got)) == per_policy * len(pols)
    for p in pols:
        assert sum(1 for _, _, q in got if q == p) == per_policy
    assert all(0 <= s < 2 and n in names for s, n, _ in got)
    assert got == ES.sample_sims(np.random.default_rng(2 ** 31 + 5), 2,
                                 names, pols, per_policy)


def test_hammer_run_on_the_wavefront_engine_is_correct(monkeypatch):
    from repro_torch.core import tracegen as TG
    cell = copy.deepcopy(S.load_cell("paper-gpu.hammer16k-wave"))
    config = copy.deepcopy(S.load_config(BENCH, "paper-gpu"))
    cut = dict(n_warps=32, n_instr=3, lines_per_instr=4)
    monkeypatch.setitem(TG.SHARD_STRESS_SPECS, "HAMMER16K",
                        dataclasses.replace(
                            TG.SHARD_STRESS_SPECS["HAMMER16K"], **cut))
    config["stress"]["HAMMER16K"].update(cut)
    cell["experiment"]["with"]["wave_size"] = 8
    cell["check"]["per_policy"] = 2
    rc = RunContext("paper-gpu.hammer16k-wave", cell, config, 2147483777,
                    0.3, False, "cpu", time.perf_counter())
    res = cli.execute(rc)
    assert res.correct, res.checks
    assert res.notes["sample_sims"] == min(8, res.attempted)
    from repro_torch.api import experiment as EXP
    real = EXP.simulate_sweep
    monkeypatch.setattr(EXP, "simulate_sweep",
                        lambda *a, **k: _altered(real(*a, **k)))
    assert not cli.execute(rc).correct


@pytest.fixture
def serve_rc():
    # one thread: the tiny model's ops are host-bound, and a busy machine
    # with a thread pool each would starve the window of steps
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield _serve_rc()
    torch.set_num_threads(threads)


def _serve_rc():
    cell = copy.deepcopy(S.load_cell(SERVE_CELL))
    cj = copy.deepcopy(S.load_config(BENCH, "qwen3-1.7b"))
    cj.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, intermediate_size=128,
              vocab_size=512, torch_dtype="float32")
    cell["engine"] = {"max_slots": 4, "max_len": 128}
    cell["pool"].update(block_tokens=16, budget_blocks=64)
    # the cell's log-normal lengths, scaled to the cut ring
    cell["mix"].update(rag_prompt={"median": 40, "mean": 52},
                       decode={"median": 4, "mean": 6}, max_context=120,
                       deck=32, n_requests=400)
    cell["check"].update(min_tokens=30, min_requests=4)
    cell["warm_steps"] = 1
    # a window long enough for some hundreds of steps on a busy CPU
    return RunContext(SERVE_CELL, cell, cj, 2147483659, 3.0, False, "cpu",
                      time.perf_counter())


def test_serve_run_is_correct(serve_rc):
    res = cli.execute(serve_rc)
    assert res.correct, res.checks
    assert set(res.e2e) == {"setup_s", "serve_tok_s", "itl_p95_ms",
                            "ttft_p95_ms"}
    assert res.notes["sample_tokens"] >= 30


def _decode_unchanged(real):
    def decode(self, tokens, cache, *, page=None):
        logits, _ = real(self, tokens, cache, page=page)
        return logits, cache           # the cache's length never advances
    return decode


def _decode_half_batch(real):
    def decode(self, tokens, cache, *, page=None):
        logits, new = real(self, tokens, cache, page=page)
        b = logits.shape[0]
        logits = logits.clone()
        logits[b - b // 2:] = logits[:b // 2]
        return logits, new
    return decode


def _decode_altered(real):
    def decode(self, tokens, cache, *, page=None):
        logits, new = real(self, tokens, cache, page=page)
        logits = logits.clone()
        rows = torch.arange(logits.shape[0])
        logits[rows, (logits.argmax(-1) + 1) % logits.shape[1]] += 1e3
        return logits, new
    return decode


@pytest.mark.parametrize("fault", [_decode_unchanged, _decode_half_batch,
                                   _decode_altered])
def test_serve_run_with_a_fault_is_not_correct(serve_rc, monkeypatch, fault):
    from repro_torch.models.model import Model
    monkeypatch.setattr(Model, "decode", fault(Model.decode))
    # judge every finished request, so that every slot is in the sample
    serve_rc.cell["check"]["min_tokens"] = 1 << 30
    assert not cli.execute(serve_rc).correct
