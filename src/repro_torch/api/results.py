"""ResultSet: labeled experiment results with axis metadata.

The raw output of a plan execution is, per emitted call, a metrics dict
of arrays with leading axes ``[P, F, ...]`` (policy × flat trace index).
``ResultSet`` keeps those blocks and adds the labels — which (scenario,
seed) each flat index is, which policy each row is — so callers select
by name instead of positional ``v[0]``/``v[1]`` indexing:

    rs.get(scenario="BFS", policy="MeDiC", seed=0)["ipc"]
    rs.sel(policy="MeDiC").to_rows()
    rs.speedup_over("Baseline")["BFS"]["MeDiC"]
    rs.to_json()

Per-entry metric arrays keep their trailing shape (per-warp vectors,
histograms, time series); ``to_rows``/``to_json`` export the scalar
metrics by default.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ResultBlock:
    """Results of ONE emitted simulate_sweep call.

    ``entries[f]`` labels flat index ``f`` as (scenario name, seed);
    ``metrics`` maps metric name to an array ``[P, F, ...]``; ``wall_s``
    is the wall-clock of the whole call (compile included on the first
    run); ``traces[f]`` optionally keeps the input trace arrays.
    """
    entries: Tuple[Tuple[str, int], ...]
    metrics: Dict[str, np.ndarray]
    wall_s: float
    traces: Optional[Tuple[Dict[str, np.ndarray], ...]] = None


class ResultSet:
    """Labeled results over the (scenario, policy, seed) axes.

    ``sel(...)`` pins axes and returns a restricted view; ``get(...)``
    resolves one (scenario, seed) entry — with ``policy`` given it
    returns per-metric arrays for that policy, otherwise arrays keep
    their leading policy axis (ordered as ``self.policies``).
    """

    def __init__(self, policies: Sequence[str],
                 blocks: Sequence[ResultBlock],
                 meta: Optional[dict] = None,
                 _sel: Optional[dict] = None):
        self._policies = tuple(policies)
        self._blocks = tuple(blocks)
        self.meta = dict(meta or {})
        self._sel = dict(_sel or {})
        self._index: Dict[Tuple[str, int], Tuple[int, int]] = {}
        for bi, blk in enumerate(self._blocks):
            for fi, key in enumerate(blk.entries):
                if key in self._index:
                    raise ValueError(f"duplicate result entry {key}")
                self._index[key] = (bi, fi)

    # -- axes ---------------------------------------------------------------

    @property
    def policies(self) -> Tuple[str, ...]:
        if "policy" in self._sel:
            return (self._sel["policy"],)
        return self._policies

    @property
    def scenarios(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for name, _ in self._entries():
            if name not in seen:
                seen.append(name)
        return tuple(seen)

    def seeds(self, scenario: str) -> Tuple[int, ...]:
        return tuple(s for n, s in self._entries() if n == scenario)

    @property
    def metrics(self) -> Tuple[str, ...]:
        return tuple(self._blocks[0].metrics) if self._blocks else ()

    def scalar_metrics(self) -> Tuple[str, ...]:
        """Metrics that are one number per (scenario, policy, seed)."""
        if not self._blocks:
            return ()
        return tuple(k for k, v in self._blocks[0].metrics.items()
                     if v.ndim == 2)

    def _entries(self):
        for blk in self._blocks:
            for name, seed in blk.entries:
                if "scenario" in self._sel and name != self._sel["scenario"]:
                    continue
                if "seed" in self._sel and seed != self._sel["seed"]:
                    continue
                yield (name, seed)

    # -- selection ----------------------------------------------------------

    def sel(self, scenario: Optional[str] = None,
            policy: Optional[str] = None,
            seed: Optional[int] = None) -> "ResultSet":
        """Pin axes by label; returns a restricted view (no copy)."""
        new = dict(self._sel)
        if scenario is not None:
            if scenario not in {n for n, _ in self._entries()}:
                raise KeyError(f"unknown scenario {scenario!r}; have "
                               f"{self.scenarios}")
            new["scenario"] = scenario
        if policy is not None:
            if policy not in self._policies:
                raise KeyError(f"unknown policy {policy!r}; have "
                               f"{self._policies}")
            new["policy"] = policy
        if seed is not None:
            if int(seed) not in {s for _, s in self._entries()}:
                raise KeyError(f"unknown seed {seed!r}; have "
                               f"{sorted({s for _, s in self._entries()})}")
            new["seed"] = int(seed)
        return ResultSet(self._policies, self._blocks, self.meta, new)

    def _resolve(self, scenario, seed) -> Tuple[str, int]:
        scenario = scenario if scenario is not None \
            else self._sel.get("scenario")
        seed = seed if seed is not None else self._sel.get("seed")
        entries = list(self._entries())
        names = {n for n, _ in entries}
        if scenario is None:
            if len(names) != 1:
                raise KeyError(f"ambiguous scenario; specify one of "
                               f"{sorted(names)}")
            scenario = next(iter(names))
        elif scenario not in names:
            raise KeyError(f"unknown scenario {scenario!r}; have "
                           f"{sorted(names)}")
        if seed is None:
            sds = [s for n, s in entries if n == scenario]
            if len(sds) != 1:
                raise KeyError(f"ambiguous seed for {scenario!r}; "
                               f"specify one of {sds}")
            seed = sds[0]
        return scenario, int(seed)

    def get(self, scenario: Optional[str] = None,
            policy: Optional[str] = None,
            seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Metrics of one (scenario, seed) entry. With ``policy`` (or a
        pinned policy) the leading policy axis is resolved too; otherwise
        every metric keeps it (ordered as ``self.policies``)."""
        scenario, seed = self._resolve(scenario, seed)
        key = (scenario, seed)
        if key not in self._index:
            raise KeyError(f"no results for scenario={scenario!r} "
                           f"seed={seed}")
        bi, fi = self._index[key]
        blk = self._blocks[bi]
        policy = policy if policy is not None else self._sel.get("policy")
        if policy is None:
            return {k: v[:, fi] for k, v in blk.metrics.items()}
        if policy not in self._policies:
            raise KeyError(f"unknown policy {policy!r}; have "
                           f"{self._policies}")
        pi = self._policies.index(policy)
        return {k: v[pi, fi] for k, v in blk.metrics.items()}

    def value(self, metric: str, scenario: Optional[str] = None,
              policy: Optional[str] = None,
              seed: Optional[int] = None):
        """One metric of one entry, as a float when it is scalar."""
        out = self.get(scenario, policy, seed)[metric]
        return float(out) if np.ndim(out) == 0 else out

    def trace(self, scenario: Optional[str] = None,
              seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Input trace arrays of one entry (needs run(keep_traces=True))."""
        scenario, seed = self._resolve(scenario, seed)
        bi, fi = self._index[(scenario, seed)]
        blk = self._blocks[bi]
        if blk.traces is None:
            raise ValueError("traces were not kept; pass keep_traces=True "
                             "to Experiment.run / Plan.execute")
        return blk.traces[fi]

    # -- derived ------------------------------------------------------------

    def speedup_over(self, base: str = "Baseline", metric: str = "ipc",
                     reduce: Optional[str] = "mean"
                     ) -> Dict[str, Dict[str, float]]:
        """Per-scenario, per-policy speedup vs the ``base`` policy.

        Ratios are computed per seed (each seed's own baseline), then
        reduced over seeds (``reduce="mean"``; ``reduce=None`` keeps the
        per-seed list). Returns ``{scenario: {policy: value}}``.
        """
        if base not in self._policies:
            raise KeyError(f"unknown base policy {base!r}")
        bi_p = self._policies.index(base)
        out: Dict[str, Dict[str, List[float]]] = {}
        for name, seed in self._entries():
            bidx, fi = self._index[(name, seed)]
            m = self._blocks[bidx].metrics[metric]
            denom = float(m[bi_p, fi])
            per = out.setdefault(name, {p: [] for p in self.policies})
            for p in self.policies:
                per[p].append(float(m[self._policies.index(p), fi]) / denom)
        if reduce is None:
            return out
        if reduce != "mean":
            raise ValueError(f"unknown reduce {reduce!r}")
        return {n: {p: float(np.mean(v)) for p, v in per.items()}
                for n, per in out.items()}

    # -- export -------------------------------------------------------------

    def to_rows(self, metrics: Optional[Sequence[str]] = None
                ) -> List[dict]:
        """Flat labeled rows, one per (scenario, policy, seed): the
        replacement for positional ``v[0]``/``v[1]`` slicing. Non-scalar
        metrics are skipped unless named explicitly (then exported as
        lists)."""
        cols = tuple(metrics) if metrics is not None \
            else self.scalar_metrics()
        rows = []
        for name, seed in self._entries():
            bi, fi = self._index[(name, seed)]
            blk = self._blocks[bi]
            for p in self.policies:
                pi = self._policies.index(p)
                row = {"scenario": name, "policy": p, "seed": seed}
                for k in cols:
                    v = blk.metrics[k][pi, fi]
                    row[k] = float(v) if np.ndim(v) == 0 \
                        else np.asarray(v).tolist()
                rows.append(row)
        return rows

    def to_json(self, metrics: Optional[Sequence[str]] = None,
                indent: Optional[int] = None) -> str:
        return json.dumps({
            "policies": list(self.policies),
            "scenarios": list(self.scenarios),
            "meta": self.meta,
            "rows": self.to_rows(metrics),
        }, indent=indent, sort_keys=True)

    # -- timing -------------------------------------------------------------

    @property
    def wall_s(self) -> float:
        """Total wall-clock over every emitted call."""
        return float(sum(b.wall_s for b in self._blocks))

    def call_walls(self) -> Tuple[float, ...]:
        return tuple(b.wall_s for b in self._blocks)

    def wall_of(self, scenario: str, seed: Optional[int] = None) -> float:
        """Wall of the call that produced ``scenario`` (same-bucket
        scenarios share one call, hence one number)."""
        if seed is None:
            sds = self.seeds(scenario)
            if not sds:
                raise KeyError(f"unknown scenario {scenario!r}")
            seed = sds[0]
        scenario, seed = self._resolve(scenario, seed)
        bi, _ = self._index[(scenario, seed)]
        return self._blocks[bi].wall_s

    def __repr__(self):
        return (f"ResultSet({len(self.scenarios)} scenarios x "
                f"{len(self.policies)} policies, "
                f"metrics={list(self.metrics)[:4]}..., "
                f"wall={self.wall_s:.2f}s)")
