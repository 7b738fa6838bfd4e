"""The frozen references against the port at a tiny size on the CPU:
the loop trace generator, the plain event simulation, the float32 Qwen3
forward and the serving engine's control-flow replay. The references
import nothing of the program; these tests are where the two meet."""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

from perfbench.drivers import serve as SV
from perfbench.harness import spec as S
from perfbench.reference import event_sim as ES
from perfbench.reference import qwen3 as Q
from perfbench.reference import serve_replay as R
from perfbench.reference import traffic as T
from perfbench.reference import wavefront_sim as WS
from perfbench.reference.tracegen import TraceSpec, generate

BENCH = S.load_benchmark()
PAPER = S.load_config(BENCH, "paper-gpu")
CUT = dict(n_warps=8, n_instr=4, lines_per_instr=8)


def _port_spec(name, **cut):
    from repro_torch.core import tracegen as TG
    from repro_torch.core import workloads as WL
    return dataclasses.replace(
        TG.TraceSpec.from_workload(WL.WORKLOADS[name]), **cut)


@pytest.mark.parametrize("name", ["BFS", "SRAD", "CONS"])
def test_frozen_tracegen_matches_the_port(name):
    from repro_torch.core import tracegen as TG
    w = PAPER["workloads"][name]
    spec = TraceSpec(name=name, mix=tuple(w["mix"]),
                     intensity=w["intensity"], phase_shift=w["phase_shift"],
                     **CUT)
    a = generate(spec, 3000000007)
    b = TG.generate(_port_spec(name, **CUT), 3000000007)
    for k in ("lines", "pcs", "compute_gap", "oracle_wtype"):
        assert np.array_equal(a[k], b[k]), k


def test_frozen_tracegen_matches_the_port_on_hammer_stress():
    from repro_torch.core import tracegen as TG
    s = PAPER["stress"]["HAMMER16K"]
    spec = TraceSpec(name="HAMMER16K", mix=tuple(s["mix"]),
                     intensity=s["intensity"], n_warps=16, n_instr=2)
    port = dataclasses.replace(TG.SHARD_STRESS_SPECS["HAMMER16K"],
                               n_warps=16, n_instr=2)
    a, b = generate(spec, 11), TG.generate(port, 11)
    assert np.array_equal(a["lines"], b["lines"])


def _policies():
    from repro_torch.core import baselines as BL
    from repro_torch.api import registry as REG
    return tuple(REG.FIG7_SWEEP_POLICIES) + (BL.MEDIC_STALE, BL.MEDIC_ORACLE,
                                             BL.MEDIC_FAST)


@pytest.mark.parametrize("name,prm_changes", [
    ("BFS", {}), ("CONS", dict(eaf_capacity=8, sets=16, ways=4)),
    ("SRAD", dict(sets=8))])
def test_event_sim_follows_the_port_bit_for_bit(name, prm_changes):
    from repro_torch.core import tracegen as TG
    from repro_torch.core.engine import SimParams, simulate_sweep
    prm = SimParams(**prm_changes)
    pols = _policies()
    tr = TG.generate(_port_spec(name, **CUT), 77)
    out = simulate_sweep(tr["lines"], tr["pcs"], tr["compute_gap"], pols,
                         n_warps=CUT["n_warps"],
                         lanes=CUT["lines_per_instr"], prm=prm,
                         oracle_types=tr["oracle_wtype"], device="cpu")
    out = {k: v.numpy() for k, v in out.items()}
    for p, pol in enumerate(pols):
        ref = ES.simulate(tr["lines"], tr["pcs"], tr["compute_gap"],
                          tr["oracle_wtype"], ES.policy_fields(pol),
                          dataclasses.asdict(prm))
        c = ES.compare({k: out[k][p] for k in out}, ref)
        assert c["counters_off"] == 0 and c["state_rel"] == 0.0, pol.name
        assert c["ipc_rel"] < 1e-6, pol.name


@pytest.mark.parametrize("name,w,wave,prm_changes", [
    ("HAMMER16K", 64, 64, {}), ("HAMMER16K", 48, 16,
                                dict(eaf_capacity=8, sets=16, ways=4)),
    ("FRONTIER2K", 40, 8, {})])
def test_wavefront_sim_follows_the_port_bit_for_bit(name, w, wave,
                                                    prm_changes):
    from repro_torch.core import tracegen as TG
    from repro_torch.core.engine import SimParams, simulate_sweep
    prm = SimParams(**prm_changes)
    pols = _policies()
    specs = {**TG.SHARD_STRESS_SPECS, **TG.STRESS_SPECS}
    spec = dataclasses.replace(specs[name], n_warps=w, n_instr=5,
                               lines_per_instr=8)
    tr = TG.generate(spec, 77)
    out = simulate_sweep(tr["lines"], tr["pcs"], tr["compute_gap"], pols,
                         n_warps=w, lanes=8, prm=prm, engine="wavefront",
                         wave_size=wave, oracle_types=tr["oracle_wtype"],
                         device="cpu")
    out = {k: v.numpy() for k, v in out.items()}
    for p, pol in enumerate(pols):
        args = (tr["lines"], tr["pcs"], tr["compute_gap"],
                tr["oracle_wtype"], ES.policy_fields(pol),
                dataclasses.asdict(prm), wave, "cpu")
        c = ES.compare({k: out[k][p] for k in out}, WS.simulate(*args))
        assert c["counters_off"] == 0 and c["state_rel"] == 0.0, pol.name
        assert c["ipc_rel"] < 1e-6, pol.name
        low = ES.compare({k: out[k][p] for k in out},
                         WS.simulate(*args, ft=torch.bfloat16))
        assert low["counters_off"] > 0, pol.name


def test_rounding_helpers():
    assert ES.round_f32(0.1) == float(np.float32(0.1))
    assert ES.round_bf16(1.0 + 2 ** -9) == 1.0          # ties to even
    assert ES.round_bf16(1.0 + 3 * 2 ** -9) == 1.0 + 2 ** -7
    assert ES.round_bf16(1000.0) == 1000.0
    assert ES.hash_index(-1, 1, 6) == ES.hash_index(0xFFFFFFFF, 1, 6)


def tiny_qwen3(dtype="float32"):
    cj = copy.deepcopy(S.load_config(BENCH, "qwen3-1.7b"))
    cj.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, intermediate_size=128,
              vocab_size=512, torch_dtype=dtype)
    return cj


def test_weights_fit_the_programs_parameter_layout():
    from repro_torch.models.model import build_model
    cj = tiny_qwen3("bfloat16")
    model = build_model(SV.model_config(cj), "cpu")
    w = Q.make_weights(cj, 5, "cpu")
    own = dict(model.named_parameters())
    assert set(w) == set(own)
    for k, p in own.items():
        assert w[k].shape == p.shape and w[k].dtype == p.dtype, k
    model.load_params(w)
    again = Q.make_weights(cj, 5, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


def test_qwen3_reference_matches_the_program_in_float32():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import build_model
    cj = tiny_qwen3()
    model = build_model(SV.model_config(cj), "cpu")
    w = Q.make_weights(cj, 9, "cpu")
    model.load_params(w)
    toks = torch.randint(1, cj["vocab_size"], (40,),
                         generator=torch.Generator().manual_seed(1))
    cache = model.init_cache(1, ShapeConfig("p", 40, 1, "prefill"))
    got, _ = model.prefill({"tokens": toks[None].to(torch.int32)}, cache)
    ref = Q.forward_logits(cj, w, toks, [39, 10], block=16)
    assert torch.allclose(got[0], ref[0], atol=1e-4, rtol=1e-4)
    # an earlier position through the program's prefill of that prefix
    cache = model.init_cache(1, ShapeConfig("p", 11, 1, "prefill"))
    got, _ = model.prefill({"tokens": toks[None, :11].to(torch.int32)},
                           cache)
    assert torch.allclose(got[0], ref[1], atol=1e-4, rtol=1e-4)


def test_fp8_round_keeps_scale_and_loses_precision():
    w = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    r = Q.fp8_round(w, 0)
    assert torch.allclose(r.abs().amax(0), w.abs().amax(0), rtol=1e-6)
    err = (r - w).abs().max() / w.abs().max()
    assert 1e-3 < err < 0.1


@pytest.mark.parametrize("budget", [12, 1000])
def test_replay_follows_the_engine(budget):
    """The control-flow replay against the port's engine at a tiny width,
    with the pool under pressure (offloads, restores, bypasses) and not."""
    from repro_torch.serving import engine as ENG
    from repro_torch.serving.pool import PoolConfig
    from repro_torch.serving.request import Request
    cell = copy.deepcopy(S.load_cell("qwen3-1.7b.serve-mix"))
    cell["engine"] = {"max_slots": 3, "max_len": 128}
    cell["pool"].update(block_tokens=16, budget_blocks=budget)
    cell["mix"].update(shared_prefix_len=32, chat_prompt=[8, 40],
                       rag_prompt=[40, 90], decode=[4, 12], n_requests=12)
    cj = tiny_qwen3()
    reqs = T.generate(cell["mix"], 4)
    eng = ENG.ServeEngine(SV.model_config(cj),
                          ENG.EngineConfig(**cell["engine"]),
                          PoolConfig(**cell["pool"]), device="cpu",
                          params=Q.make_weights(cj, 3, "cpu"))
    eng_reqs = [Request(**dataclasses.asdict(r)) for r in reqs]
    ENG.COUNTS.reset()
    eng.run(eng_reqs, max_steps=1 << 20)     # to the last request
    program = dict(
        requests={r.rid: {f: getattr(r, f) for f in R.REQUEST_FIELDS}
                  for r in eng_reqs if r.slot >= 0},
        pool=dict(fetches=eng.pool.fetches,
                  bypassed_blocks=eng.pool.bypassed_blocks,
                  evictions_by_type=eng.pool.evictions_by_type,
                  resident_blocks=int((eng.pool._slot >= 0).sum()),
                  seq_type=eng.pool.seq_type, hits=eng.pool.hits,
                  accesses=eng.pool.accesses),
        counts=dict(admissions=ENG.COUNTS.admissions,
                    decode_steps=ENG.COUNTS.decode_steps,
                    offloads=ENG.COUNTS.offloads,
                    restores=ENG.COUNTS.restores))
    ref = R.replay(reqs, cell["engine"], cell["pool"],
                   ("decode", ENG.COUNTS.decode_steps))
    assert R.compare(program, ref) == []
    assert all(r.finish_step >= 0 for r in eng_reqs)
    if budget < 100:
        assert ENG.COUNTS.offloads > 0 and eng.pool.fetches > 0
