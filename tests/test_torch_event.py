"""The port's exact event engine against the JAX reference's, on the CPU.

``repro_torch`` ``simulate_sweep(engine="event", device="cpu")`` (the
eager plain loop, all P·S simulations in one batched loop) against
``repro`` ``simulate_sweep(engine="event")`` (jitted, vmapped) on the same
traces. Integer metrics and every per-element output (``warp_time``,
``makespan``, ``ratio_over_time``, ``warp_type``, ``warp_hit_ratio``)
must be bitwise equal; the float reductions of ``finalize_outputs`` sum
in torch's order, not XLA's, so they are held to rtol 1e-6. Each case
stays near 2k request steps: the eager loop costs ~2 ms a step here.

Also: one request step of the port's ``_request_step`` against the
reference's, the event-loop gate's contract on the CPU, the kernel's
layout plan, and ``wave_size=1`` on the port's wavefront engine against
its event engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import registry as JREG
from repro.core import baselines as JBL
from repro.core import engine as JE
from repro.core import tracegen as JTG
from repro.core import workloads as JWL
from repro.core.engine import event as JEV
from repro.core.engine.state import init_state as j_init_state
from repro.policy import to_arrays as j_to_arrays
from repro.policy import ops as JPOL

from repro_torch.api import registry as REG
from repro_torch.core import baselines as BL
from repro_torch.core import engine as E
from repro_torch.core import simulator as SIM
from repro_torch.core.engine import event as EV
from repro_torch.kernels.event_loop import ops as EVL
from repro_torch.policy import stack_policies

#: float reductions whose summation order differs between torch and XLA
FLOAT_REDUCTIONS = ("ipc", "ipc_makespan", "qdelay_sum", "stall_cycles",
                    "energy", "perf_per_energy", "mean_qdelay", "miss_rate")

FOUR = ((BL.BASELINE, BL.PCAL, BL.WBYP, BL.MEDIC),
        (JBL.BASELINE, JBL.PCAL, JBL.WBYP, JBL.MEDIC))
FIG7 = (REG.FIG7_SWEEP_POLICIES, JREG.FIG7_SWEEP_POLICIES)
LADDER = (BL.LABELING_LADDER, JBL.LABELING_LADDER)


def check_event(tr, pols, *, n_warps, lanes, prm=None):
    """Both packages' event engines on trace dict ``tr``; every metric
    compared. ``prm`` is a dict of SimParams fields."""
    prm = prm or {}
    args = (tr["lines"], tr["pcs"], tr["compute_gap"])
    ref = JE.simulate_sweep(
        *[jnp.asarray(a) for a in args], pols[1], n_warps=n_warps,
        lanes=lanes, prm=JE.SimParams(**prm), engine="event",
        oracle_types=jnp.asarray(tr["oracle_wtype"]))
    out = E.simulate_sweep(
        *args, pols[0], n_warps=n_warps, lanes=lanes,
        prm=E.SimParams(**prm), oracle_types=tr["oracle_wtype"],
        device="cpu")
    assert set(out) == set(ref)
    for k in ref:
        a, b = np.asarray(ref[k]), out[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k in FLOAT_REDUCTIONS:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
    return out


def _spec(workload, **kw):
    return dataclasses.replace(
        JTG.TraceSpec.from_workload(JWL.WORKLOADS[workload]), **kw)


def _phased_cut(n_warps, n_instr):
    """PHASED48 at ``n_warps`` warps, its first ``n_instr`` instructions
    (the gap stays per instruction, [I])."""
    tr = JTG.generate(dataclasses.replace(JTG.PHASED_SPECS["PHASED48"],
                                          n_warps=n_warps), 0)
    return {k: (v[:n_instr] if k in ("lines", "pcs", "oracle_wtype",
                                     "compute_gap") else v)
            for k, v in tr.items()}


def _seeds(workload, seeds, **kw):
    tr = JTG.generate_batch([_spec(workload, **kw)], seeds)
    return {k: v[0] for k, v in tr.items()}


CASES = {
    # one warp: no interleaving, the whole trace in order
    "single_warp_BFS": (lambda: JTG.generate(
        _spec("BFS", n_warps=1, n_instr=32), 0), FOUR, 1, 16, None),
    "single_warp_BP": (lambda: JTG.generate(
        _spec("BP", n_warps=1, n_instr=32), 0), FOUR, 1, 16, None),
    # the fig7 sweep's 11 policies on two paper workloads, cut
    "BFS_fig7": (lambda: JTG.generate(
        _spec("BFS", n_warps=8, n_instr=8), 0), FIG7, 8, 16, None),
    "BP_fig7": (lambda: JTG.generate(
        _spec("BP", n_warps=8, n_instr=8), 0), FIG7, 8, 16, None),
    # three seeds stacked: outputs [P, S]
    "seed_stacked": (lambda: _seeds("SSSP", (0, 1, 2), n_warps=6,
                                    n_instr=4),
                     ((BL.MEDIC, BL.WBYP, BL.PCAL),
                      (JBL.MEDIC, JBL.WBYP, JBL.PCAL)), 6, 16, None),
    # the labeling ladder (oracle and stale rungs) with a gap of shape [I]
    "phased_oracle": (lambda: _phased_cut(6, 12), LADDER, 6, 16, None),
    # an EAF that resets every 8 evictions: the generation bump
    "eaf_capacity_8": (lambda: JTG.generate(
        _spec("CONS", n_warps=8, n_instr=8), 0),
        ((BL.BASELINE, BL.EAF, BL.MEDIC), (JBL.BASELINE, JBL.EAF,
                                           JBL.MEDIC)), 8, 16,
        dict(eaf_capacity=8)),
    # a window of 0 accesses: every warp's window closes on every request
    "window_0": (lambda: JTG.generate(
        _spec("BFS", n_warps=4, n_instr=4, lines_per_instr=8), 0),
        ((BL.BASELINE, BL.MEDIC), (JBL.BASELINE, JBL.MEDIC)), 4, 8,
        dict(sampling_interval=0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_event_engine_matches_reference(case):
    make, pols, n_warps, lanes, prm = CASES[case]
    tr = make()
    out = check_event(tr, pols, n_warps=n_warps, lanes=lanes, prm=prm)
    lead = (len(pols[0]),) + ((3,) if case == "seed_stacked" else ())
    assert out["ipc"].shape == lead


def test_request_step_matches_reference():
    """``_request_step`` (re-exported by ``core.simulator``) on a batch of
    two simulations against the reference's scalar step, request by
    request, on the whole state and the done time."""
    rng = np.random.default_rng(0)
    pols = (BL.MEDIC, BL.PCAL)
    jpols = (JBL.MEDIC, JBL.PCAL)
    n_warps, prm, jprm = 4, E.SimParams(sets=8, ways=4), \
        JE.SimParams(sets=8, ways=4)
    pa = EV.bucket(torch.zeros((1, 1, n_warps, 1), dtype=torch.int32),
                   torch.zeros((1, 1, n_warps), dtype=torch.int32),
                   torch.zeros((1,)), torch.zeros((1, 1, n_warps),
                                                  dtype=torch.int32),
                   stack_policies(pols), n_warps)
    st = EV.batch_state(2, n_warps, prm, "cpu")
    jst = [j_init_state(n_warps, jprm) for _ in jpols]
    jpa = [j_to_arrays(p) for p in jpols]
    jtok = [JPOL.pcal_tokens(a, n_warps) for a in jpa]
    j_step = jax.jit(JEV._request_step, static_argnums=(2,))
    for _ in range(40):
        w, addr = int(rng.integers(n_warps)), int(rng.integers(-1, 40))
        pc, t = int(rng.integers(6)), float(rng.integers(0, 400))
        req = (torch.full((2,), t), torch.full((2,), w),
               torch.full((2,), addr, dtype=torch.int32),
               torch.full((2,), pc, dtype=torch.int32),
               torch.full((2,), addr >= 0), torch.zeros(2, dtype=torch.int32))
        st, done = SIM._request_step(st, req, prm, pa.pa, pa.tokens)
        for n in range(2):
            jreq = (jnp.float32(t), jnp.int32(w), jnp.int32(addr),
                    jnp.int32(pc), jnp.bool_(addr >= 0), jnp.int32(0))
            jst[n], jdone = j_step(jst[n], jreq, jprm, jpa[n], jtok[n])
            assert float(done[n]) == float(jdone)
            row = EV.state_row(st, n)
            for f in ("tags", "rrip", "meta_type", "bank_free", "cur_row",
                      "hp_free", "lp_free", "eaf", "eaf_gen", "eaf_ctr",
                      "pc_hits", "pc_acc", "pc_req", "tot_hits", "tot_acc"):
                np.testing.assert_array_equal(
                    getattr(row, f).numpy(), np.asarray(getattr(jst[n], f)),
                    err_msg=f)
            for f in row.clf._fields:
                np.testing.assert_array_equal(
                    getattr(row.clf, f).numpy(),
                    np.asarray(getattr(jst[n].clf, f)), err_msg=f)
            for k, v in row.metrics.items():
                np.testing.assert_array_equal(
                    v.numpy(), np.asarray(jst[n].metrics[k]), err_msg=k)


def _cpu_bucket(n_warps=6, n_instr=3, lanes=8, pols=(BL.MEDIC, BL.EAF)):
    tr = JTG.generate(_spec("BFS", n_warps=n_warps, n_instr=n_instr,
                            lines_per_instr=lanes), 0)
    t = {k: torch.as_tensor(np.asarray(tr[k]))[None]
         for k in ("lines", "pcs", "oracle_wtype")}
    gap = torch.as_tensor(np.asarray(tr["compute_gap"]))[None]
    return EV.bucket(t["lines"], t["pcs"], gap, t["oracle_wtype"],
                     stack_policies(pols), n_warps)


def test_bypass_decision_matches_reference():
    """``request.bypass_decision`` on a batch of simulations, each with its
    own policy, warmed classifier rows and PC tables, against the
    reference's per-simulation call."""
    from repro.core.engine import request as JREQ
    from repro_torch.core.engine import request as REQ
    rng = np.random.default_rng(1)
    pols = REG.FIG7_SWEEP_POLICIES + (BL.MEDIC_ORACLE, BL.MEDIC_STALE)
    jpols = JREG.FIG7_SWEEP_POLICIES + (JBL.MEDIC_ORACLE, JBL.MEDIC_STALE)
    n, n_warps, prm = len(pols), 5, E.SimParams(pc_entries=4)
    st = EV.batch_state(n, n_warps, prm, "cpu")
    st.clf.warp_type.copy_(torch.as_tensor(rng.integers(0, 5, (n, n_warps))))
    st.clf.accesses.copy_(torch.as_tensor(rng.integers(0, 40, (n, n_warps))))
    for f in ("pc_hits", "pc_acc", "pc_req"):
        getattr(st, f).copy_(torch.as_tensor(rng.integers(0, 60, (n, 4))))
    b = EV.bucket(torch.zeros((1, 1, n_warps, 1), dtype=torch.int32),
                  torch.zeros((1, 1, n_warps), dtype=torch.int32),
                  torch.zeros((1,)), torch.zeros((1, 1, n_warps),
                                                 dtype=torch.int32),
                  stack_policies(pols), n_warps)
    for _ in range(8):
        w = torch.as_tensor(rng.integers(0, n_warps, n))
        addr = torch.as_tensor(rng.integers(-1, 1 << 20, n), dtype=torch.int32)
        pc = torch.as_tensor(rng.integers(0, 9, n), dtype=torch.int32)
        owt = torch.as_tensor(rng.integers(0, 5, n), dtype=torch.int32)
        byp, wtype, pidx = REQ.bypass_decision(st, w, addr, pc, addr >= 0,
                                               prm, b.pa, b.tokens, owt)
        for k in range(n):
            jst = j_init_state(n_warps, JE.SimParams(pc_entries=4))
            row = EV.state_row(st, k)
            jst = jst._replace(
                clf=jst.clf._replace(
                    warp_type=jnp.asarray(row.clf.warp_type.numpy()),
                    accesses=jnp.asarray(row.clf.accesses.numpy())),
                **{f: jnp.asarray(getattr(row, f).numpy())
                   for f in ("pc_hits", "pc_acc", "pc_req")})
            pa = j_to_arrays(jpols[k])
            got = JREQ.bypass_decision(
                jst, jnp.int32(w[k]), jnp.int32(addr[k]), jnp.int32(pc[k]),
                jnp.bool_(addr[k] >= 0), JE.SimParams(pc_entries=4), pa,
                JPOL.pcal_tokens(pa, n_warps), jnp.int32(owt[k]))
            assert (bool(byp[k]), int(wtype[k]), int(pidx[k])) == \
                (bool(got[0]), int(got[1]), int(got[2])), jpols[k].name


def _flat(out):
    """``(st, ready, ptr, ratio_t)`` of a loop as a list of tensors."""
    st, *rest = out
    return [*(getattr(st, f) for f in st._fields
              if f not in ("clf", "metrics")), *st.clf,
            *(st.metrics[k] for k in sorted(st.metrics)), *rest]


def test_gate_auto_runs_the_plain_loop_on_the_cpu():
    b = _cpu_bucket()
    before = EVL.EVENT_LOOP.launches
    got = EVL.event_loop(b, n_warps=6, lanes=8, prm=E.SimParams())
    want = EV.event_loop(b, n_warps=6, lanes=8, prm=E.SimParams())
    ref = EVL.event_loop(b, n_warps=6, lanes=8, prm=E.SimParams(),
                         backend="ref")
    for x, y, z in zip(_flat(got), _flat(want), _flat(ref)):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert EVL.EVENT_LOOP.launches == before


def test_gate_cuda_on_cpu_tensors_raises():
    b = _cpu_bucket()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        EVL.event_loop(b, n_warps=6, lanes=8, prm=E.SimParams(),
                       backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        EVL.event_loop_cuda(b, n_warps=6, lanes=8, prm=E.SimParams())
    with pytest.raises(ValueError, match="unknown event backend"):
        EVL.event_loop(b, n_warps=6, lanes=8, prm=E.SimParams(),
                       backend="triton")


@pytest.mark.parametrize("prm,n_warps,want", [
    # the paper's hierarchy: state 67 KB and 48 warps' rows in shared
    (dict(), 48, (True, True, 70656)),
    (dict(), 2048, (True, True, 68736 + 81920)),
    # 4096 warps' rows (160 KB) do not fit beside the state
    (dict(), 4096, (True, False, 68736)),
    (dict(sets=4096, ways=4, eaf_bits=7680), 64, (True, False, 230528)),
    # a state past the budget lives in global memory; the rows still fit
    (dict(sets=4096, ways=4, eaf_bits=8192), 32, (False, True, 1280)),
])
def test_plan_event_loop_layout(prm, n_warps, want):
    plan = EVL.plan_event_loop(E.SimParams(**prm), n_warps)
    assert (plan.state, plan.rows, plan.smem_bytes) == want
    assert plan.smem_bytes <= EVL.SMEM_BUDGET


def test_plan_event_loop_overrides():
    prm = E.SimParams()
    assert EVL.plan_event_loop(prm, 48, state=False, rows=False) == \
        EVL.EventLoopPlan(False, False, 0)
    assert EVL.plan_event_loop(prm, 48, rows=False) == \
        EVL.EventLoopPlan(True, False, 68736)
    with pytest.raises(ValueError, match="state"):
        EVL.plan_event_loop(E.SimParams(sets=8192), 48, state=True)
    with pytest.raises(ValueError, match="rows"):
        EVL.plan_event_loop(prm, 8192, rows=True)


def test_wave_of_one_warp_equals_event_in_the_port():
    """The port's wavefront engine with waves of one warp against its own
    event engine, at the reference's tolerance for that rung
    (tests/test_engine_differential.py)."""
    tr = JTG.generate(_spec("BP", n_warps=8, n_instr=8), 0)
    args = (tr["lines"], tr["pcs"], tr["compute_gap"])
    kw = dict(n_warps=8, lanes=16, prm=E.SimParams(), device="cpu")
    pols = (BL.BASELINE, BL.MEDIC)
    ev = E.simulate_sweep(*args, pols, engine="event", **kw)
    wf = E.simulate_sweep(*args, pols, engine="wavefront", wave_size=1,
                          **kw)
    for k in ev:
        np.testing.assert_allclose(wf[k].numpy(), ev[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_event_is_the_default_engine():
    tr = JTG.generate(_spec("BFS", n_warps=3, n_instr=2,
                            lines_per_instr=4), 0)
    args = (tr["lines"], tr["pcs"], tr["compute_gap"])
    kw = dict(n_warps=3, lanes=4, prm=E.SimParams(), device="cpu")
    one = E.simulate(*args, pol=BL.MEDIC, **kw)
    sweep = E.simulate_sweep(*args, (BL.MEDIC,), engine="event", **kw)
    for k in one:
        assert torch.equal(one[k], sweep[k][0]), k
