"""Declarative experiment API (the port of ``repro.api``).

One front door for every sweep:

    Scenario   what to simulate   (named, hashable; lowers via tracegen)
    Experiment scenarios × policies × engine; ``compile()`` -> Plan
    Plan       the minimal set of ``simulate_sweep`` calls (one per
               (trace-shape, engine) bucket, policies on the leading
               axis, scenarios/seeds stacked on the flat axis)
    ResultSet  labeled results: ``.sel()``, ``.speedup_over()``,
               ``.to_rows()`` / ``.to_json()``
    registry   the paper suites as data: ``registry.PAPER_FIG7``,
               ``registry.STRESS``, ``registry.PAPER_SERVING``

Experiments run on the card unless ``device="cpu"`` is given; serving
buckets (``engine="serving"``) run the host-side serving simulator.
``mesh=`` / ``mesh_axes=`` place a sweep's policy, seed and warp axes on
a ``repro_torch.sharding.Mesh`` (``repro_torch.launch.make_local_mesh``).
"""
from repro_torch.api import registry
from repro_torch.api.experiment import Experiment, Plan, PlanCall, run
from repro_torch.api.results import ResultBlock, ResultSet
from repro_torch.api.scenario import Scenario

__all__ = [
    "Experiment", "Plan", "PlanCall", "ResultBlock", "ResultSet",
    "Scenario", "registry", "run",
]
