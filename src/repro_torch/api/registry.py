"""Named experiment registry: the paper's evaluation as data (the port of
``repro.api.registry``).

The whole evaluation is two lines:

    from repro_torch import api
    rows = api.registry.PAPER_FIG7.run().to_rows()

Experiments are registered under string names
(``api.registry.get("paper_fig7")``) and exposed as module constants.
``FIG7_SWEEP_POLICIES`` is the canonical fig7 policy batch — every named
baseline plus the Rand(p) probe points the Rand(ideal) column derives
from — shared by ``repro_torch.paper_figures`` and ad-hoc callers.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.api.experiment import Experiment
from repro_torch.api.scenario import Scenario
from repro_torch.core import baselines as BL
from repro_torch.core import tracegen as TG
from repro_torch.core import workloads as WL
from repro_torch.policy import Policy

#: every policy any paper figure needs, in one batch
FIG7_SWEEP_POLICIES: Tuple[Policy, ...] = tuple(BL.ALL_NAMED) + (
    BL.rand(0.25), BL.rand(0.5), BL.rand(0.75))

#: the stress-matrix comparison set — one policy per mechanism family
STRESS_POLICIES: Tuple[Policy, ...] = (BL.BASELINE, BL.PCAL, BL.WBYP,
                                       BL.MEDIC)

#: the phased-family labeling ladder: Baseline, then MeDiC with frozen
#: phase-0 labels (stale) / periodic reclassification (online, at two
#: windows) / ground-truth per-phase labels (oracle)
PHASED_POLICIES: Tuple[Policy, ...] = BL.LABELING_LADDER

#: the serving A/B ladder: LRU (Baseline preset), MeDiC, and the stale /
#: oracle labeling variants — one simulator run per policy on the SAME
#: arrival stream
SERVING_POLICIES: Tuple[Policy, ...] = (BL.BASELINE, BL.MEDIC,
                                        BL.MEDIC_STALE, BL.MEDIC_ORACLE)

QUICK_WORKLOADS: Tuple[str, ...] = ("BFS", "SSSP", "BP", "CONS")
QUICK_PHASED: Tuple[str, ...] = ("PHASED48", "PHASED256")
QUICK_RECOVER: Tuple[str, ...] = ("PHASED_RECOVER48", "PHASED_RECOVER256")


def paper_fig7(workloads=WL.WORKLOAD_NAMES, seeds=(0,),
               engine: str = "event", name: str = "paper_fig7"
               ) -> Experiment:
    """The Fig 7 evaluation: workloads × (baselines + Rand probes).
    All 48-warp workloads share one trace shape, so the plan compiles
    to a single call per engine (one event-loop launch)."""
    return Experiment(
        name,
        tuple(Scenario.workload(w, seeds=seeds) for w in workloads),
        FIG7_SWEEP_POLICIES, engine=engine)


def stress(scenarios=tuple(TG.STRESS_SPECS), seeds=(0,),
           name: str = "stress") -> Experiment:
    """The 1k–4k-warp scheduler-stress matrix on the wavefront engine —
    one call per distinct trace shape."""
    return Experiment(
        name,
        tuple(Scenario.stress(s, seeds=seeds) for s in scenarios),
        STRESS_POLICIES, engine="wavefront")


def stress_shard(scenarios=tuple(TG.SHARD_STRESS_SPECS), seeds=(0,),
                 policies=STRESS_POLICIES,
                 name: str = "stress_shard") -> Experiment:
    """The 16k–64k-warp sharded-sweep stress tier (``HAMMER16K`` /
    ``WIDE64K``) on the wavefront engine. Registered without a mesh (a
    mesh holds concrete devices); attach one at run time, e.g.::

        from repro_torch.launch import make_local_mesh
        rs = registry.stress_shard(("HAMMER16K",)).with_(
            mesh=make_local_mesh(1, 4),
            mesh_axes=(None, None, "model")).run()

    ``policies`` trims the batch. WIDE64K cannot be lowered at 65,536
    warps (its address space overflows int32 in tracegen, as in the
    reference), so materializing it raises."""
    return Experiment(
        name,
        tuple(Scenario.stress(s, seeds=seeds) for s in scenarios),
        tuple(policies), engine="wavefront")


def phased(scenarios=tuple(TG.PHASED_SPECS), seeds=(0,),
           engine: str = "wavefront", name: str = "paper_phased"
           ) -> Experiment:
    """The drifting-regime suite: PHASED_* scenarios × the labeling
    ladder. Runs on either engine (``.with_(engine=...)``); the wavefront
    default is what completes the 1k–2k-warp sizes."""
    return Experiment(
        name,
        tuple(Scenario.phased(s, seeds=seeds) for s in scenarios),
        PHASED_POLICIES, engine=engine)


def recover(scenarios=tuple(TG.PHASED_RECOVER_SPECS), seeds=(0,),
            engine: str = "wavefront", name: str = "paper_recover"
            ) -> Experiment:
    """The recovery-direction mirror of ``phased``: PHASED_RECOVER_*
    scenarios (miss -> mixed -> hit drift) × the same labeling ladder."""
    return Experiment(
        name,
        tuple(Scenario.phased(s, seeds=seeds) for s in scenarios),
        PHASED_POLICIES, engine=engine)


def serving(scenarios=("SERVE_POISSON64", "SERVE_BURSTY64",
                       "SERVE_DIURNAL64", "SERVE_POISSON2K"),
            seeds=(0,), policies=SERVING_POLICIES,
            name: str = "paper_serving") -> Experiment:
    """Open-loop serving A/Bs on the vectorized continuous-batching
    simulator (host numpy): arrival-process scenarios × the
    LRU/MeDiC/stale/oracle pool-policy ladder. Every policy sees the
    identical request stream per (scenario, seed)."""
    return Experiment(
        name,
        tuple(Scenario.serving(s, seeds=seeds) for s in scenarios),
        tuple(policies), engine="serving")


PAPER_FIG7 = paper_fig7()
PAPER_FIG7_QUICK = paper_fig7(QUICK_WORKLOADS, name="paper_fig7_quick")
STRESS = stress()
STRESS_SHARD = stress_shard()
PAPER_PHASED = phased()
PAPER_PHASED_QUICK = phased(QUICK_PHASED, name="paper_phased_quick")
PAPER_RECOVER = recover()
PAPER_RECOVER_QUICK = recover(QUICK_RECOVER, name="paper_recover_quick")
PAPER_SERVING = serving()
PAPER_SERVING_QUICK = serving(("SERVE_POISSON64", "SERVE_BURSTY64"),
                              policies=(BL.BASELINE, BL.MEDIC),
                              name="paper_serving_quick")

EXPERIMENTS: Dict[str, Experiment] = {
    e.name: e for e in (PAPER_FIG7, PAPER_FIG7_QUICK, STRESS,
                        STRESS_SHARD, PAPER_PHASED, PAPER_PHASED_QUICK,
                        PAPER_RECOVER, PAPER_RECOVER_QUICK,
                        PAPER_SERVING, PAPER_SERVING_QUICK)}


def get(name: str) -> Experiment:
    if name not in EXPERIMENTS:
        raise KeyError(f"unknown experiment {name!r}; registered: "
                       f"{sorted(EXPERIMENTS)}")
    return EXPERIMENTS[name]
