"""The serving half of the port's declarative API, and the port's
simulator against the port's ``ServeEngine``, on the CPU.

  * api        — the reference's serving validation, plan bucketing and
                 ``pool_backend`` tests (tests/test_serving_sim.py),
                 mirrored on ``repro_torch.api``; ``PAPER_SERVING_QUICK``'s
                 ``ResultSet`` equal value for value to the reference's;
  * parity     — the simulator replayed on the IDENTICAL
                 ``generate_requests`` workload equals the port's
                 ``ServeEngine.run`` (2-layer reduced Qwen3, 8 requests, 2
                 slots, plain PyTorch versions on the CPU) per request and
                 per pool counter, on both pool backends, as the reference
                 pins its own pair;
  * A/B        — ``chip_smoke.py``'s serving A/B workload through the
                 simulator alone gives the aggregates pinned from the
                 reference's engine (``PINNED_AB``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import api as japi

from repro_torch import api
from repro_torch.configs.base import get_config
from repro_torch.core import baselines as BL
from repro_torch.serving.engine import EngineConfig, ServeEngine
from repro_torch.serving.pool import POOL_POLICIES, PoolConfig
from repro_torch.serving.request import ServeWorkload, generate_requests
from repro_torch.serving.sim import (SERVING_SPECS, ServingSpec,
                                     from_requests, simulate_serving)

#: the reference's examples/serve_medic.py A/B (24 requests, chat 0.6,
#: budget 48 blocks of 16, 4 slots of 448, seed 0, 2000 steps), as the
#: JAX package's engine gives it (tests/test_torch_serving_engine.py)
PINNED_AB = {
    "lru": dict(steps=2000, completed=8, tokens_out=627, stall_steps=7367,
                fetches=1940, bypassed_blocks=0),
    "medic": dict(steps=2000, completed=23, tokens_out=1438,
                  stall_steps=4050, fetches=1719, bypassed_blocks=1037),
}


# -- the declarative api ------------------------------------------------------


def test_api_serving_validation():
    sc = api.Scenario.serving("SERVE_POISSON64")
    assert sc.is_serving and sc.shape == (-1, 64, 192)
    with pytest.raises(ValueError, match="need engine='serving'"):
        api.Experiment("bad", (sc,), (BL.MEDIC,), engine="event")
    wc = api.Scenario.workload("BFS")
    with pytest.raises(ValueError, match="only serving scenarios"):
        api.Experiment("bad2", (wc,), (BL.MEDIC,), engine="serving")
    with pytest.raises(ValueError, match="pool_backend"):
        api.Experiment("bad3", (sc,), (BL.MEDIC,), engine="serving",
                       pool_backend="nope")
    with pytest.raises(ValueError, match="unknown serving scenario"):
        api.Scenario.serving("NOPE")
    with pytest.raises(ValueError, match="n_warps"):
        api.Scenario("bad4", SERVING_SPECS["SERVE_POISSON64"], (0,),
                     n_warps=4)
    with pytest.raises(TypeError, match="no trace spec"):
        sc.trace_spec
    # the reference's refusal: the serving simulator takes no mesh
    with pytest.raises(ValueError, match="does not take a mesh"):
        api.Experiment("m", (sc,), (BL.MEDIC,), engine="serving",
                       mesh=object())


def test_api_serving_plan_buckets_by_shape():
    exp = api.registry.get("paper_serving_quick")
    plan = exp.compile()
    # both quick scenarios share (slots=64, requests=192): one bucket
    assert plan.n_calls == 1
    assert "[serving] slots=64 requests=192" in plan.describe()
    full = api.registry.PAPER_SERVING.compile()
    assert full.n_calls == 2                 # 64-slot bucket + 2k bucket
    assert full.describe() == \
        japi.registry.PAPER_SERVING.compile().describe()
    assert plan.describe() == \
        japi.registry.PAPER_SERVING_QUICK.compile().describe()
    assert [p.name for p in api.registry.SERVING_POLICIES] == \
        [p.name for p in japi.registry.SERVING_POLICIES]
    assert api.registry.get("paper_serving") is api.registry.PAPER_SERVING


def test_api_pool_backend_plumbs_through_experiment():
    spec = dataclasses.replace(SERVING_SPECS["SERVE_POISSON64"],
                               n_requests=64, max_steps=1000)
    sc = api.Scenario.serving(spec)
    fast = api.Experiment("t_fast", (sc,), (BL.MEDIC,), engine="serving",
                          device="cpu")
    ref = fast.with_(name="t_ref", pool_backend="ref")
    assert fast.pool_backend == "auto"
    rf, rr = fast.run(), ref.run()
    for k in ("completed", "steps", "p99_latency", "stall_steps",
              "fetches", "hit_ratio"):
        assert rf.value(k, policy="MeDiC") == rr.value(k, policy="MeDiC")


def test_serving_run_needs_the_card_unless_cpu(monkeypatch):
    """A serving bucket runs on the host, but an experiment keeps the
    port's one device contract: no card and no ``device="cpu"`` raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        api.registry.PAPER_SERVING_QUICK.run()


def test_paper_serving_quick_matches_reference():
    rs = api.registry.PAPER_SERVING_QUICK.with_(device="cpu").run()
    jrs = japi.registry.PAPER_SERVING_QUICK.run()
    assert rs.policies == jrs.policies
    assert rs.scenarios == jrs.scenarios
    for sc in rs.scenarios:
        assert rs.seeds(sc) == jrs.seeds(sc) == (0,)
    assert rs.to_rows() == jrs.to_rows()
    assert rs.to_json() == jrs.to_json()
    for sc in ("SERVE_POISSON64", "SERVE_BURSTY64"):
        for pol in ("Baseline", "MeDiC"):
            for k in ("completed", "p99_latency", "hit_ratio", "goodput",
                      "max_concurrency", "p99_latency_censored"):
                assert rs.value(k, scenario=sc, policy=pol, seed=0) == \
                    jrs.value(k, scenario=sc, policy=pol, seed=0), (sc, pol)


# -- the simulator against the port's ServeEngine ----------------------------


@pytest.fixture(scope="module")
def tiny_cfg():
    return get_config("qwen3_1_7b").reduced(num_layers=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small eager ops run faster on one thread (and share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("policy_name", ["lru", "medic"])
def test_sim_matches_serve_engine_per_request(tiny_cfg, policy_name):
    """The identical generate_requests workload through the port's engine
    and the port's simulator (both pool backends): per-request lifecycle
    stamps and every pool counter equal."""
    wl = ServeWorkload(n_requests=8, arrival_rate=4.0)
    reqs = generate_requests(wl, seed=1)
    pc = PoolConfig(budget_blocks=32, block_tokens=16, policy=policy_name)
    eng = ServeEngine(tiny_cfg, EngineConfig(max_slots=2, max_len=448), pc,
                      device="cpu")
    snap = eng.run(reqs, max_steps=4000)
    assert snap["completed"] == 8            # parity on a finished run

    spec = ServingSpec("T_PARITY", process="closed", n_requests=8,
                       max_slots=2, max_len=448, block_tokens=16,
                       budget_blocks=32, sampling_interval=32,
                       fetch_latency=8.0, fetch_occupancy=1.0,
                       max_steps=4000)
    stream = from_requests(reqs)
    for backend in ("fast", "ref"):
        out = simulate_serving(stream, spec,
                               policy=POOL_POLICIES[policy_name],
                               pool_backend=backend)
        ra = out["request_arrays"]
        for k in ("enqueue_step", "first_token_step", "finish_step",
                  "generated", "stall_steps"):
            assert ra[k].tolist() == [getattr(r, k) for r in reqs], \
                (backend, k)
        pool = out["pool"]
        assert pool["fetches"] == eng.pool.fetches
        assert pool["bypassed_blocks"] == eng.pool.bypassed_blocks
        for k in ("hits", "accesses", "seq_type", "evictions_by_type"):
            np.testing.assert_equal(pool[k], getattr(eng.pool, k),
                                    err_msg=f"{backend}: {k}")
        for k in ("steps", "completed", "tokens_out", "stall_steps"):
            assert out["metrics"][k] == snap[k], (backend, k)


@pytest.mark.parametrize("policy_name", ["lru", "medic"])
def test_ab_workload_aggregates_match_pinned(policy_name):
    """chip_smoke.py's A/B workload through the simulator alone gives the
    aggregates pinned from the reference's engine; the run is cut at 2000
    steps, and under LRU 12 requests are never admitted (enqueue_step -1
    here, the Request default 0 in the engine)."""
    reqs = generate_requests(ServeWorkload(n_requests=24, chat_frac=0.6),
                             seed=0)
    spec = ServingSpec("T_AB", process="closed", n_requests=24, max_slots=4,
                       max_len=448, block_tokens=16, budget_blocks=48,
                       sampling_interval=32, fetch_latency=8.0,
                       fetch_occupancy=1.0, max_steps=2000)
    outs = [simulate_serving(from_requests(reqs), spec,
                             policy=POOL_POLICIES[policy_name],
                             pool_backend=b) for b in ("fast", "ref")]
    for out in outs:
        m = out["metrics"]
        assert {k: m[k] for k in PINNED_AB[policy_name]} == \
            PINNED_AB[policy_name]
    ra = outs[0]["request_arrays"]
    np.testing.assert_equal(ra, outs[1]["request_arrays"])
    never = int((ra["enqueue_step"] < 0).sum())
    assert never == (12 if policy_name == "lru" else 0)
