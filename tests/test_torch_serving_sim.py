"""The port's open-loop serving simulator (``repro_torch.serving.sim``)
against the reference's, bit for bit.

The simulator is host numpy in float64 and int64 in both packages, so
nothing here has a tolerance: every request array, pool counter and
metric must be equal (``np.testing.assert_equal``, NaN equal to NaN).

  * arrivals   — ``arrival_times`` and ``generate_serving`` for the four
                 processes × seeds {0, 1, 7}, and the ``ServingSpec``
                 refusals with the reference's messages;
  * simulator  — the three 64-slot named scenarios × the serving policy
                 ladder (Baseline, MeDiC, MeDiC-stale, MeDiC-oracle); the
                 port's two pool backends against each other on the
                 reference's cut SERVE_BURSTY64; SERVE_POISSON2K cut to
                 64 steps (2048 slots saturate at about step 43, so the
                 cut run already holds 2048 in flight; the whole run is
                 in ``chip_smoke.py``); the zero-request and closed-loop
                 order cases.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import baselines as JBL
from repro.serving import sim as JSIM
from repro.serving.sim import spec as JSPEC

from repro_torch.core import baselines as BL
from repro_torch.serving import sim as SIM
from repro_torch.serving.sim import spec as SPEC

PROCESSES = ("poisson", "bursty", "diurnal", "closed")
POLICIES = ("Baseline", "MeDiC", "MeDiC-stale", "MeDiC-oracle")


def _policy(name):
    t = {p.name: p for p in (BL.BASELINE, BL.MEDIC, BL.MEDIC_STALE,
                             BL.MEDIC_ORACLE)}[name]
    j = {p.name: p for p in (JBL.BASELINE, JBL.MEDIC, JBL.MEDIC_STALE,
                             JBL.MEDIC_ORACLE)}[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    return t, j


def _specs(name=None, **kw):
    """The same spec in both packages: a named one (replaced by ``kw``)
    or a small test spec."""
    if name is not None:
        t, j = SIM.SERVING_SPECS[name], JSIM.SERVING_SPECS[name]
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        return dataclasses.replace(t, **kw), dataclasses.replace(j, **kw)
    base = dict(name=f"T_{kw.get('process', 'poisson').upper()}", rate=1.5,
                n_requests=256)
    base.update(kw)
    return SIM.ServingSpec(**base), JSIM.ServingSpec(**base)


def _equal_runs(a, b):
    assert a.keys() == b.keys() == {"metrics", "request_arrays", "pool"}
    for part in ("request_arrays", "pool"):
        assert a[part].keys() == b[part].keys(), part
        for k in a[part]:
            x, y = np.asarray(a[part][k]), np.asarray(b[part][k])
            assert x.dtype == y.dtype, (part, k)
            np.testing.assert_equal(x, y, err_msg=f"{part}.{k}")
    assert list(a["metrics"]) == list(b["metrics"])       # same key order
    for k in a["metrics"]:
        assert type(a["metrics"][k]) is type(b["metrics"][k]), k
    np.testing.assert_equal(a["metrics"], b["metrics"])


# -- arrivals -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("process", PROCESSES)
def test_arrivals_and_streams_match_reference(process, seed):
    t, j = _specs(process=process)
    ta, ja = SIM.arrival_times(t, seed), JSIM.arrival_times(j, seed)
    assert ta.dtype == ja.dtype == np.float64
    np.testing.assert_equal(ta, ja)
    ts, js = SIM.generate_serving(t, seed), JSIM.generate_serving(j, seed)
    assert list(ts) == list(js)
    for k in ts:
        assert ts[k].dtype == js[k].dtype, k
        np.testing.assert_equal(ts[k], js[k], err_msg=k)


def test_named_specs_and_constants_match_reference():
    assert SPEC.PROCESSES == JSPEC.PROCESSES
    assert list(SIM.SERVING_SPECS) == list(JSIM.SERVING_SPECS)
    for name in SIM.SERVING_SPECS:
        t, j = _specs(name)
        assert dataclasses.asdict(t.pool_config()) == \
            dataclasses.asdict(j.pool_config())
        assert t.n_pseudo_slots == j.n_pseudo_slots
    assert SIM.POOL_BACKENDS == JSIM.POOL_BACKENDS
    from repro.serving.sim import arrivals as JARR
    from repro_torch.serving.sim import arrivals as ARR
    for tag in ("GAP", "CLASS", "PROMPT", "DECODE", "PREFIX"):
        assert getattr(ARR, f"TAG_SERVE_{tag}") == \
            getattr(JARR, f"TAG_SERVE_{tag}")


@pytest.mark.parametrize("bad", [
    dict(process="uniform"), dict(rate=0.0), dict(n_requests=-1),
    dict(chat_frac=1.5), dict(burst_duty=1.0),
    dict(burst_boost=5.0, burst_duty=0.25), dict(diurnal_amp=1.0),
    dict(max_slots=0), dict(n_shared_prefixes=0),
    dict(rag_prompt=(192, 512)),
], ids=lambda d: "-".join(d))
def test_spec_refusals_match_reference(bad):
    kw = dict(name="T_BAD", **bad)
    with pytest.raises(ValueError) as jerr:
        JSIM.ServingSpec(**kw)
    with pytest.raises(ValueError) as terr:
        SIM.ServingSpec(**kw)
    assert str(terr.value) == str(jerr.value)


# -- the simulator ------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["SERVE_POISSON64", "SERVE_BURSTY64",
                                  "SERVE_DIURNAL64"])
def test_simulator_matches_reference(name, policy):
    t, j = _specs(name)
    tp, jp = _policy(policy)
    out = SIM.simulate_serving(SIM.generate_serving(t, 0), t, policy=tp)
    _equal_runs(out, JSIM.simulate_serving(JSIM.generate_serving(j, 0), j,
                                           policy=jp))
    assert out["metrics"]["completed"] == t.n_requests


@pytest.mark.parametrize("policy", POLICIES)
def test_fast_pool_backend_matches_ref(policy):
    """The vectorized ``access_batch`` transaction equals the sequential
    per-key one, in the port, on the reference's cut SERVE_BURSTY64."""
    t, _ = _specs("SERVE_BURSTY64", n_requests=96, max_steps=1500)
    tp, _ = _policy(policy)
    reqs = SIM.generate_serving(t, 0)
    _equal_runs(SIM.simulate_serving(reqs, t, policy=tp, pool_backend="fast"),
                SIM.simulate_serving(reqs, t, policy=tp, pool_backend="ref"))


def test_poisson2k_cut_matches_reference_at_2048_in_flight():
    """SERVE_POISSON2K cut to 64 steps: the slots saturate by about step
    43, so the cut run holds all 2048 in flight; the whole run (4096
    requests in <= 1200 steps) is checked in chip_smoke.py."""
    t, j = _specs("SERVE_POISSON2K")
    tp, jp = _policy("MeDiC")
    out = SIM.simulate_serving(SIM.generate_serving(t, 0), t, policy=tp,
                               max_steps=64)
    _equal_runs(out, JSIM.simulate_serving(JSIM.generate_serving(j, 0), j,
                                           policy=jp, max_steps=64))
    assert out["metrics"]["max_concurrency"] == 2048
    assert out["metrics"]["steps"] == 64


def test_zero_request_stream_is_a_no_op():
    t, j = _specs(process="poisson", n_requests=0)
    out = SIM.simulate_serving(SIM.generate_serving(t, 0), t)
    _equal_runs(out, JSIM.simulate_serving(JSIM.generate_serving(j, 0), j))
    m = out["metrics"]
    assert m["steps"] == 0 and m["completed"] == 0 and m["admitted"] == 0
    assert m["tokens_out"] == 0 and m["fetches"] == 0
    assert np.isnan(m["mean_latency"])


def test_closed_loop_admits_in_request_order():
    """All arrivals at t=0: the first max_slots requests take slots
    0..S-1 at step 0 and admission steps are non-decreasing in id."""
    t, j = _specs(process="closed", n_requests=24, max_slots=8)
    out = SIM.simulate_serving(SIM.generate_serving(t, 0), t)
    _equal_runs(out, JSIM.simulate_serving(JSIM.generate_serving(j, 0), j))
    ra = out["request_arrays"]
    assert np.all(ra["enqueue_step"][:8] == 0)
    assert np.all(np.diff(ra["enqueue_step"]) >= 0)
    assert np.all(ra["finish_step"] >= 0)


def test_bad_pool_backend_refused():
    t, _ = _specs(process="poisson", n_requests=4)
    with pytest.raises(ValueError, match="pool_backend"):
        SIM.simulate_serving(SIM.generate_serving(t, 0), t,
                             pool_backend="nope")
