"""One function per paper artefact (Figs 2/4/5/7/8) on the altitude-A
simulator: the port of ``benchmarks/paper_figures.py``.

Each function returns (rows, derived) where rows are CSV-able dicts, and
takes ``device=`` (``None``: the card; ``"cpu"``: the plain PyTorch
versions). All simulation goes through ``repro_torch.api``: one
single-scenario ``Experiment`` per (workload, seed block, engine,
device), which the plan compiler lowers to one seed-stacked
``simulate_sweep`` call — on the event engine one launch of the
event-loop kernel for all policies × seeds — with results read back by
label through ``ResultSet``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch import api
from repro_torch.api.registry import FIG7_SWEEP_POLICIES as SWEEP_POLICIES
from repro_torch.core import baselines as BL
from repro_torch.core import workloads as WL
from repro_torch.core.simulator import Policy, SimParams

PRM = SimParams()

# default seed block swept TOGETHER with the policy batch: the scenario
# carries the whole block, so one `simulate_sweep` call per workload
# covers policies x seeds.
FIG_SEEDS: Tuple[int, ...] = (0,)

_CACHE: Dict[tuple, Dict[int, Dict[str, dict]]] = {}


def _result_dict(rs: api.ResultSet, workload: str, pol_name: str,
                 seed: int) -> dict:
    """One policy's metrics + the trace + the whole-sweep wall, in the
    dict shape the figure functions consume."""
    d = dict(rs.get(scenario=workload, policy=pol_name, seed=seed))
    d["sweep_wall_s"] = rs.wall_s     # wall time of the WHOLE sweep
    d["trace"] = rs.trace(workload, seed)
    return d


def _sweep(workload: str, seed: int = 0,
           seeds: Tuple[int, ...] = None,
           engine: str = "event", device=None) -> Dict[str, dict]:
    """All SWEEP_POLICIES on one workload, batched over policies and the
    seed block containing ``seed``. Returns name->metrics for ``seed``."""
    if seeds is None or seed not in seeds:
        seeds = FIG_SEEDS if seed in FIG_SEEDS else (seed,)
    key = (workload, seeds, engine, str(device))
    if key not in _CACHE:
        exp = api.Experiment(f"fig:{workload}",
                             (api.Scenario.workload(workload, seeds=seeds),),
                             SWEEP_POLICIES, engine=engine, prm=PRM,
                             device=device)
        rs = exp.run(keep_traces=True)
        _CACHE[key] = {
            s: {pol.name: _result_dict(rs, workload, pol.name, s)
                for pol in SWEEP_POLICIES}
            for s in seeds}
    return _CACHE[key][seed]


_BY_NAME: Dict[str, Policy] = {p.name: p for p in SWEEP_POLICIES}
_OFF_SWEEP_CACHE: Dict[tuple, dict] = {}


def _run(workload: str, pol: Policy, seed: int = 0,
         seeds: Tuple[int, ...] = None, engine: str = "event",
         device=None) -> dict:
    if _BY_NAME.get(pol.name) == pol:
        return _sweep(workload, seed, seeds, engine, device)[pol.name]
    # off-sweep policy (e.g. BL.RAND_SWEEP points): a one-policy
    # experiment
    key = (workload, pol, seed, engine, str(device))
    if key not in _OFF_SWEEP_CACHE:
        exp = api.Experiment(
            f"fig:{workload}:{pol.name}",
            (api.Scenario.workload(workload, seeds=(seed,)),),
            (pol,), engine=engine, prm=PRM, device=device)
        rs = exp.run(keep_traces=True)
        _OFF_SWEEP_CACHE[key] = _result_dict(rs, workload, pol.name, seed)
    return _OFF_SWEEP_CACHE[key]


# ---------------------------------------------------------------------------
# Fig 2 — inter-warp hit-ratio heterogeneity
# ---------------------------------------------------------------------------

def fig2_heterogeneity(workloads=("BFS", "BP", "CONS"), device=None):
    rows = []
    for wl in workloads:
        out = _run(wl, BL.BASELINE, device=device)
        hr = out["warp_hit_ratio"]
        hist, edges = np.histogram(hr, bins=np.linspace(0, 1, 11))
        for lo, hi, n in zip(edges[:-1], edges[1:], hist):
            rows.append({"workload": wl, "hit_ratio_bin": f"{lo:.1f}-{hi:.1f}",
                         "n_warps": int(n)})
    spread = {wl: float(_run(wl, BL.BASELINE, device=device)
                        ["warp_hit_ratio"].std())
              for wl in workloads}
    return rows, {"hit_ratio_stddev": spread}


# ---------------------------------------------------------------------------
# Fig 4 — divergence stability over time
# ---------------------------------------------------------------------------

def fig4_stability(workload="BFS", device=None):
    out = _run(workload, BL.BASELINE, device=device)
    rt = out["ratio_over_time"]          # [I, W]
    half = rt.shape[0] // 2
    a = rt[half - 8:half].mean(axis=0)
    b = rt[-8:].mean(axis=0)
    corr = float(np.corrcoef(a, b)[0, 1])
    rows = [{"workload": workload, "warp": int(w),
             "ratio_mid": float(a[w]), "ratio_end": float(b[w])}
            for w in range(0, rt.shape[1], 6)]
    return rows, {"half_to_half_correlation": corr}


# ---------------------------------------------------------------------------
# Fig 5 — L2 queueing-latency distribution
# ---------------------------------------------------------------------------

def fig5_queueing(workload="BFS", device=None):
    out = _run(workload, BL.BASELINE, device=device)
    hist = out["qdelay_hist"]
    bins = ["0", "1", "2-3", "4-7", "8-15", "16-31", "32-63", "64-127",
            "128-255", "256-511", "512-1023", "1024+"]
    rows = [{"workload": workload, "queue_cycles": b, "requests": int(n)}
            for b, n in zip(bins, hist)]
    return rows, {"mean_qdelay_cycles": float(out["mean_qdelay"]),
                  "frac_over_64_cycles":
                      float(hist[7:].sum() / max(hist.sum(), 1))}


# ---------------------------------------------------------------------------
# Fig 7 — performance of MeDiC vs all baselines over 15 workloads
# ---------------------------------------------------------------------------

def fig7_performance(workloads=WL.WORKLOAD_NAMES, seeds=(0,),
                     engine="event", device=None):
    """Speedup table. With several ``seeds`` the per-workload speedup is
    the mean over seeds, and every seed of a workload comes out of the
    same seed-stacked ``simulate_sweep`` call. ``engine`` selects the
    simulation engine (the golden fig7 numbers are the event engine's)."""
    seeds = tuple(seeds)
    policies = list(BL.ALL_NAMED)
    rows = []
    speedups: Dict[str, List[float]] = {p.name: [] for p in policies}
    speedups["Rand(ideal)"] = []
    for wl in workloads:
        per_pol: Dict[str, List[float]] = {p.name: [] for p in policies}
        ideal: List[float] = []
        for sd in seeds:
            base = float(_run(wl, BL.BASELINE, sd, seeds, engine,
                              device)["ipc"])
            for pol in policies:
                per_pol[pol.name].append(
                    float(_run(wl, pol, sd, seeds, engine, device)["ipc"])
                    / base)
            # idealized Rand: best bypass probability per workload
            # (paper fn.3)
            ideal.append(max(
                float(_run(wl, BL.rand(p), sd, seeds, engine,
                           device)["ipc"]) / base
                for p in (0.25, 0.5, 0.75)))
        for pol in policies:
            s = float(np.mean(per_pol[pol.name]))
            speedups[pol.name].append(s)
            rows.append({"workload": wl, "policy": pol.name,
                         "speedup": round(s, 4)})
        best = float(np.mean(ideal))
        speedups["Rand(ideal)"].append(best)
        rows.append({"workload": wl, "policy": "Rand(ideal)",
                     "speedup": round(best, 4)})

    def hmean(xs):
        xs = np.asarray(xs)
        return float(len(xs) / np.sum(1.0 / xs))

    derived = {f"hmean_speedup[{k}]": round(hmean(v), 4)
               for k, v in speedups.items()}
    derived["medic_vs_best_prior"] = round(
        hmean(speedups["MeDiC"]) / max(hmean(speedups["PCAL"]),
                                       hmean(speedups["EAF"]),
                                       hmean(speedups["PC-Byp"])), 4)
    if len(seeds) > 1:
        derived["n_seeds"] = len(seeds)
    return rows, derived


# ---------------------------------------------------------------------------
# Fig 8 — energy efficiency
# ---------------------------------------------------------------------------

def fig8_energy(workloads=WL.WORKLOAD_NAMES, device=None):
    rows = []
    ratios = []
    for wl in workloads:
        base = float(_run(wl, BL.BASELINE, device=device)["perf_per_energy"])
        med = float(_run(wl, BL.MEDIC, device=device)["perf_per_energy"])
        rows.append({"workload": wl, "policy": "MeDiC",
                     "perf_per_energy_vs_base": round(med / base, 4)})
        ratios.append(med / base)
    n = len(ratios)
    return rows, {"hmean_energy_eff_gain":
                  round(float(n / np.sum(1.0 / np.asarray(ratios))), 4)}
