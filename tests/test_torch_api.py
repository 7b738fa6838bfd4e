"""The port's declarative API and figure harness against the reference's,
on the CPU.

A small experiment (two workloads cut to 6 warps × 4 instructions × 16
lanes, three policies) is compiled and run by both packages on both
engines: the plans (bucketing, ``describe()``, ``n_calls``,
``n_executables``) must be equal, and so must the ``ResultSet``s' labels,
selections, speedups, rows and JSON — integer and per-element metrics
exactly, the float reductions to rtol 1e-6 (torch and XLA sum in other
orders). Then the port's figure functions against
``benchmarks/paper_figures.py`` on cut workloads, patched into both
packages' workload tables for this module only. Also the refusals: the
reference's mesh and serving-engine checks, and a run without a card
unless ``device="cpu"``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from benchmarks import paper_figures as JPF
from repro import api as japi
from repro.core import baselines as JBL
from repro.core import tracegen as JTG
from repro.core import workloads as JWL

from repro_torch import api
from repro_torch import paper_figures as PF
from repro_torch.core import baselines as BL
from repro_torch.core import tracegen as TG
from repro_torch.core import workloads as WL
from repro_torch.launch import make_local_mesh

FLOAT_REDUCTIONS = ("ipc", "ipc_makespan", "qdelay_sum", "stall_cycles",
                    "energy", "perf_per_energy", "mean_qdelay", "miss_rate")

CUT = dict(n_warps=6, n_instr=4)
POLS = ((BL.BASELINE, BL.WBYP, BL.MEDIC),
        (JBL.BASELINE, JBL.WBYP, JBL.MEDIC))


def _scenarios(pkg, tg, wl):
    """BFS (seed 0) and BP (seeds 0, 1), cut: one bucket of 3 traces."""
    def cut(name):
        return dataclasses.replace(
            tg.TraceSpec.from_workload(wl.WORKLOADS[name]), **CUT)
    return (pkg.Scenario.from_spec(cut("BFS"), seeds=(0,)),
            pkg.Scenario.from_spec(cut("BP"), seeds=(0, 1)))


def _experiments(engine):
    port = api.Experiment("small", _scenarios(api, TG, WL), POLS[0],
                          engine=engine, device="cpu")
    ref = japi.Experiment("small", _scenarios(japi, JTG, JWL), POLS[1],
                          engine=engine)
    return port, ref


def _same(a, b, key):
    a, b = np.asarray(a), np.asarray(b)
    if key in FLOAT_REDUCTIONS:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=key)
    else:
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.fixture(scope="module", params=["event", "wavefront"])
def small(request):
    port, ref = _experiments(request.param)
    return port, ref, port.run(keep_traces=True), ref.run(keep_traces=True)


def test_plan_matches_reference(small):
    port, ref, _, _ = small
    pp, rp = port.compile(), ref.compile()
    assert pp.describe() == rp.describe()
    assert (pp.n_calls, pp.n_executables) == (rp.n_calls, rp.n_executables)
    assert [c.shape for c in pp.calls] == [c.shape for c in rp.calls]
    assert [c.flat for c in pp.calls] == [c.flat for c in rp.calls]


def test_resultset_labels_and_values_match_reference(small):
    _, _, rs, jrs = small
    assert rs.policies == jrs.policies
    assert rs.scenarios == jrs.scenarios
    assert rs.meta == jrs.meta
    assert set(rs.metrics) == set(jrs.metrics)
    assert rs.scalar_metrics() == jrs.scalar_metrics()
    for sc in rs.scenarios:
        assert rs.seeds(sc) == jrs.seeds(sc)
        for seed in rs.seeds(sc):
            got, want = rs.get(sc, seed=seed), jrs.get(sc, seed=seed)
            for k in want:
                _same(got[k], want[k], k)
            np.testing.assert_array_equal(rs.trace(sc, seed)["lines"],
                                          jrs.trace(sc, seed)["lines"])


def test_resultset_selection_matches_reference(small):
    _, _, rs, jrs = small
    one, jone = rs.sel(scenario="BP", seed=1), jrs.sel(scenario="BP", seed=1)
    for k, v in jone.get(policy="MeDiC").items():
        _same(one.get(policy="MeDiC")[k], v, k)
    assert rs.sel(policy="WByp").policies == ("WByp",)
    _same(rs.value("l2_hits", "BFS", "MeDiC"),
          jrs.value("l2_hits", "BFS", "MeDiC"), "l2_hits")
    with pytest.raises(KeyError):
        rs.sel(scenario="SSSP")


def test_speedup_rows_and_json_match_reference(small):
    _, _, rs, jrs = small
    sp, jsp = rs.speedup_over("Baseline"), jrs.speedup_over("Baseline")
    assert sp.keys() == jsp.keys()
    for sc in jsp:
        for p in jsp[sc]:
            np.testing.assert_allclose(sp[sc][p], jsp[sc][p], rtol=1e-6)
    rows, jrows = rs.to_rows(), jrs.to_rows()
    assert [(r["scenario"], r["policy"], r["seed"]) for r in rows] == \
        [(r["scenario"], r["policy"], r["seed"]) for r in jrows]
    for r, jr in zip(rows, jrows):
        assert r.keys() == jr.keys()
        for k in jr:
            if k not in ("scenario", "policy", "seed"):
                _same(r[k], jr[k], k)
    doc, jdoc = json.loads(rs.to_json()), json.loads(jrs.to_json())
    assert {k: doc[k] for k in ("policies", "scenarios", "meta")} == \
        {k: jdoc[k] for k in ("policies", "scenarios", "meta")}
    assert len(doc["rows"]) == len(jdoc["rows"])


def test_one_call_per_shape_bucket():
    """Scenarios of one trace shape share one call; another shape gets
    its own, as in the reference."""
    specs = [dataclasses.replace(TG.TraceSpec.from_workload(
        WL.WORKLOADS[n]), **CUT) for n in ("BFS", "BP")]
    odd = dataclasses.replace(specs[0], n_warps=5, name="BFS5")
    exp = api.Experiment("b", tuple(api.Scenario.from_spec(s)
                                    for s in specs + [odd]),
                         (BL.MEDIC,), device="cpu")
    plan = exp.compile()
    assert plan.n_calls == 2 and [c.flat for c in plan.calls] == [2, 1]
    assert api.registry.PAPER_FIG7.compile().n_calls == 1
    assert api.registry.PAPER_FIG7_QUICK.compile().calls[0].flat == 4
    assert api.registry.get("stress").engine == "wavefront"
    shard = api.registry.get("stress_shard")
    jshard = japi.registry.get("stress_shard")
    assert shard.engine == jshard.engine == "wavefront"
    assert shard.mesh is None and jshard.mesh is None
    assert [s.name for s in shard.scenarios] == \
        [s.name for s in jshard.scenarios] == ["HAMMER16K", "WIDE64K"]
    assert [s.shape for s in shard.scenarios] == \
        [s.shape for s in jshard.scenarios]
    assert [p.name for p in shard.policies] == \
        [p.name for p in jshard.policies]
    with pytest.raises(KeyError):
        api.registry.get("stress_shard_missing")


def test_refusals_name_the_missing_slices():
    sc = _scenarios(api, TG, WL)
    # the serving simulator is ported: serving scenarios and the serving
    # engine answer as the reference's do, refusals included
    serve = api.Scenario.serving("SERVE_POISSON64")
    jserve = japi.Scenario.serving("SERVE_POISSON64")
    assert (serve.name, serve.shape, serve.seeds, serve.is_serving) == \
        (jserve.name, jserve.shape, jserve.seeds, jserve.is_serving)
    for pkg, trace, pol in ((api, sc, BL.MEDIC),
                            (japi, _scenarios(japi, JTG, JWL), JBL.MEDIC)):
        with pytest.raises(ValueError, match="only serving scenarios"):
            pkg.Experiment("s", trace, (pol,), engine="serving")
    # sharded sweeps are ported: the mesh refusals are the reference's
    jsc = _scenarios(japi, JTG, JWL)
    msgs = []
    for pkg, trace, pol in ((api, sc, BL.MEDIC), (japi, jsc, JBL.MEDIC)):
        with pytest.raises(ValueError, match="without a mesh") as ei:
            pkg.Experiment("m", trace, (pol,), mesh_axes=("x",))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    msgs = []
    for pkg, pol, mesh in (
            (api, BL.MEDIC, make_local_mesh(1, 2, device="cpu")),
            (japi, JBL.MEDIC, AbstractMesh((1, 2), ("data", "model")))):
        with pytest.raises(ValueError, match="does not take a mesh") as ei:
            pkg.Experiment("m", (pkg.Scenario.serving("SERVE_POISSON64"),),
                           (pol,), engine="serving", mesh=mesh)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="wave_size"):
        api.Experiment("w", sc, (BL.MEDIC,), wave_size=4)
    with pytest.raises(ValueError, match="duplicate policy"):
        api.Experiment("d", sc, (BL.MEDIC, BL.MEDIC))


def test_run_needs_the_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = api.Experiment("c", _scenarios(api, TG, WL)[:1], (BL.MEDIC,))
    assert exp.device is None
    with pytest.raises(RuntimeError, match="CUDA device"):
        exp.run()
    with pytest.raises(RuntimeError, match="CUDA device"):
        PF.fig4_stability("BFS")


# ---------------------------------------------------------------------------
# the figure harness on cut workloads
# ---------------------------------------------------------------------------

FIG_CUT = dict(n_warps=6, n_instr=16)
FIG_WORKLOADS = ("BFS", "BP")


@pytest.fixture(scope="module")
def cut_tables():
    """Both packages' workload tables hold cut specs for this module; the
    harnesses' memo caches start and end empty."""
    caches = (PF._CACHE, PF._OFF_SWEEP_CACHE, JPF._CACHE,
              JPF._OFF_SWEEP_CACHE)
    for c in caches:
        c.clear()
    with pytest.MonkeyPatch.context() as mp:
        for wl in (WL, JWL):
            for name in FIG_WORKLOADS:
                mp.setitem(wl.WORKLOADS, name, dataclasses.replace(
                    wl.WORKLOADS[name], **FIG_CUT))
        yield
    for c in caches:
        c.clear()


FIGS = {
    "fig2": lambda m, **kw: m.fig2_heterogeneity(FIG_WORKLOADS, **kw),
    "fig4": lambda m, **kw: m.fig4_stability("BFS", **kw),
    "fig5": lambda m, **kw: m.fig5_queueing("BP", **kw),
    "fig7": lambda m, **kw: m.fig7_performance(FIG_WORKLOADS, **kw),
    "fig8": lambda m, **kw: m.fig8_energy(FIG_WORKLOADS, **kw),
}


@pytest.mark.parametrize("fig", list(FIGS))
def test_figure_matches_reference(cut_tables, fig):
    rows, derived = FIGS[fig](PF, device="cpu")
    jrows, jderived = FIGS[fig](JPF)
    assert rows == jrows
    assert derived.keys() == jderived.keys()
    for k, v in jderived.items():
        if isinstance(v, dict):
            assert v.keys() == derived[k].keys()
            for kk in v:
                np.testing.assert_allclose(derived[k][kk], v[kk], rtol=1e-6)
        else:
            np.testing.assert_allclose(derived[k], v, rtol=1e-6, err_msg=k)
