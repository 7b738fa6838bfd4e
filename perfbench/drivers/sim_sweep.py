"""Simulator cells: whole policy sweeps through the port's experiment API
(``repro_torch.api``), back to back.

A cell names a registry experiment of the program (``paper_fig7``,
``stress_shard`` ...) and its arguments; the configuration file fixes the
simulated hierarchy (``sim_params``), the policies and the workloads'
trace parameters. Set-up builds the cell's kernels and runs one sweep on
a seed of its own. The window runs ``Experiment.run`` on a fresh trace
seed each sweep (``trace_seed(seed, k)``), as a user's seed sweep does:
trace generation, the plan, the simulations on the card and the results
on the host, every sweep. Its rate counts the simulated memory requests
completed: ``(trace lines >= 0).sum() x policies x seeds`` of every
sweep, over the window's wall time.

Once the window has closed, a sample of the window's simulations drawn
from the seed, ``check.per_policy`` of them for every policy, is run again by the plain reference of the cell's engine
(``reference.event_sim``, or ``reference.wavefront_sim`` on the card) on
traces the frozen generator (``reference.tracegen``) makes from the
configuration's parameters:
integer counters must agree exactly, the float32 state
(makespan, queue delay, stall cycles) exactly, and the IPC within
``ipc_rel`` (it sums per-warp rates in another order).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List

import numpy as np

from perfbench.harness.run import LayerContext, RunContext, RunResult
from perfbench.harness.trace import DeviceTrace, Spans
from perfbench.reference import event_sim as ES
from perfbench.reference import wavefront_sim as WS
from perfbench.reference.tracegen import TraceSpec, generate

_MASK64 = (1 << 64) - 1
_GAMMA = 0x9E3779B97F4A7C15

#: outputs kept from each simulation of the window for the comparison
KEPT = ("ipc",) + ES.STATE_OUTPUTS + ES.INT_OUTPUTS


def trace_seed(seed: int, k: int) -> int:
    """The trace seed of sweep ``k`` of a run (``k = -1``: set-up's),
    a splitmix64 draw in [0, 2^31)."""
    z = (int(seed) + (k + 2) * _GAMMA) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) % (1 << 31)


def trace_spec(config: dict, table: str, name: str) -> TraceSpec:
    """The reference's trace parameters of scenario ``name`` from the
    configuration's ``table`` (``workloads`` or ``stress``)."""
    fields = {f.name for f in dataclasses.fields(TraceSpec)}
    entry = {k: tuple(v) if isinstance(v, list) else v
             for k, v in config[table][name].items() if k in fields}
    return TraceSpec(name=name, **entry)


def run(rc: RunContext) -> RunResult:
    import torch
    from repro_torch.api import experiment as EXP
    from repro_torch.api import registry as REG
    from repro_torch.core.engine import SimParams
    from repro_torch.core.engine import wavefront as WF
    from repro_torch.kernels import _build

    cell, cj = rc.cell, rc.config
    ex = cell["experiment"]
    prm = SimParams(**cj["sim_params"])
    names = list(ex["scenarios"])
    policies = cj[ex["policies"]]
    make = getattr(REG, ex["registry"])
    cuda = torch.device(rc.device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def experiment(seed: int):
        return make(names, seeds=(seed,), **ex.get("args", {})).with_(
            prm=prm, device=rc.device, **ex.get("with", {}))

    # ---- set-up ----------------------------------------------------------
    if cuda:
        _build.build_all(cell["kernels"])
    warm = experiment(trace_seed(rc.seed, -1)).run(keep_traces=True)
    if list(warm.policies) != [p["name"] for p in policies] or \
            list(warm.scenarios) != names:
        raise RuntimeError(
            f"the program's experiment runs {list(warm.policies)} on "
            f"{list(warm.scenarios)}; the configuration states "
            f"{[p['name'] for p in policies]} on {names}")
    if experiment(0).engine != ex["engine"]:
        raise RuntimeError(f"the program's experiment runs the "
                           f"{experiment(0).engine} engine, the cell "
                           f"states {ex['engine']}")
    plan = experiment(0).compile().calls
    calls = [(c.flat, *c.shape) for c in plan]
    wave_size = ex.get("with", {}).get("wave_size")
    waves = [(min(wave_size or WF.default_wave_size(c.shape[1]), c.shape[1]),
              c.shape[2]) for c in plan]
    trace = DeviceTrace() if rc.trace else None
    spans = Spans()
    if trace is not None:
        trace.warm()
        EXP.simulate_sweep = spans.wrap("simulate_sweep", EXP.simulate_sweep)
    launches = _launch_counter(cell["kernels"])
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - rc.t_start

    # ---- the window -------------------------------------------------------
    outputs: List[Dict[str, Dict[str, np.ndarray]]] = []
    ends = [t0]
    requests = 0
    mark = None
    while True:
        if trace is not None and mark is None and \
                time.perf_counter() - t0 >= rc.seconds - min(
                    cell["trace_seconds"], rc.seconds):
            trace.start()
            mark = dict(sweeps=len(outputs), waves=WF.WAVES.waves,
                        launches=launches())
        seed = trace_seed(rc.seed, len(outputs))
        with spans.span("sweep") if trace is not None and trace.running \
                else contextlib.nullcontext():
            rs = experiment(seed).run(keep_traces=True)
        sweep = {}
        for name in names:
            requests += int((rs.trace(scenario=name, seed=seed)["lines"]
                             >= 0).sum()) * len(policies)
            got = rs.get(scenario=name, seed=seed)
            sweep[name] = {k: np.asarray(got[k]) for k in KEPT}
        outputs.append(sweep)
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= rc.seconds:
            break
    summary = trace.stop() if trace is not None and trace.running else None
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = {"setup_s": setup_s, "sim_req_s": requests / window_s}

    layer = None
    if summary is not None:
        n = len(outputs) - mark["sweeps"]
        layer = LayerContext(
            trace=summary, spans=spans,
            counts=dict(sweeps=n, waves=WF.WAVES.waves - mark["waves"],
                        **{f"launches.{k}": v - mark["launches"][k]
                           for k, v in launches().items()}),
            calls={"sweep": calls * n, "wave": waves,
                   "policies": [len(policies)]},
            config=cj)

    # ---- judge a sample of the window's simulations -----------------------
    chk = cell["check"]
    rng = np.random.default_rng(rc.seed)
    sample = ES.sample_sims(rng, len(outputs), names,
                            [p["name"] for p in policies],
                            chk["per_policy"])
    worst = {"ipc_rel": 0.0, "state_rel": 0.0, "counters_off": 0}
    traces = {}
    for k, name, pol in sample:
        key = (k, name)
        if key not in traces:
            traces[key] = generate(
                trace_spec(cj, ex["table"], name), trace_seed(rc.seed, k))
        tr = traces[key]
        p = [q["name"] for q in policies].index(pol)
        args = (tr["lines"], tr["pcs"], tr["compute_gap"],
                tr["oracle_wtype"], policies[p], cj["sim_params"])
        ref = (WS.simulate(*args, wave_size, rc.device)
               if ex["engine"] == "wavefront" else ES.simulate(*args))
        prog = {m: v[p] for m, v in outputs[k][name].items()}
        c = ES.compare(prog, ref)
        worst["ipc_rel"] = max(worst["ipc_rel"], c["ipc_rel"])
        worst["state_rel"] = max(worst["state_rel"], c["state_rel"])
        worst["counters_off"] += c["counters_off"]
    lim = chk["limits"]
    checks = [(k, float(worst[k]), lim[k]) for k in ("ipc_rel", "state_rel",
                                                     "counters_off")]
    return RunResult(
        e2e=e2e, checks=checks,
        attempted=len(outputs) * len(names) * len(policies),
        failed=0, memory_peak_bytes=int(peak), layer=layer,
        notes={"sweep_s_p10_p50_p90": [float(q) for q in np.quantile(
                   np.diff(ends), [0.1, 0.5, 0.9])],
               "sweeps": len(outputs), "requests": requests,
               "window_s": window_s, "sample_sims": len(sample)})


def _launch_counter(kernels):
    """A reader of the launch counts of the cell's kernels (each
    kernel's ``Kernel.launches``)."""
    from repro_torch.kernels.cache_pass import ops as CPASS
    from repro_torch.kernels.event_loop import ops as EVL
    from repro_torch.kernels.wavefront_scan import ops as WSCAN
    known = {"event_loop": EVL.EVENT_LOOP, "wave_cache": CPASS.WAVE_CACHE,
             "wave_queue": WSCAN.WAVE_QUEUE}

    def read():
        return {k: known[k].launches for k in kernels}
    return read
