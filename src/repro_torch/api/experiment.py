"""Experiment: scenarios × policies × engine, compiled to a minimal Plan
(the port of ``repro.api.experiment``).

    exp  = Experiment("fig7", scenarios, policies, engine="event")
    plan = exp.compile()     # inspectable, no traces materialized yet
    rs   = plan.execute()    # == exp.run()

The plan compiler buckets scenarios by trace shape (I, W, L): every
scenario in a bucket rides the seed-stack axis of ONE ``simulate_sweep``
call (policies on the leading axis), so the whole experiment runs in
exactly one call per (shape, engine) bucket — on the event engine one
launch of the event-loop kernel per bucket. ``n_executables`` counts the
distinct call signatures (shape, flat batch size, policy count, engine,
wave_size, backends, SimParams), as the reference counts its jit
executables.

Runs go to the card unless ``device`` says otherwise (``device="cpu"``
runs the plain PyTorch versions). A block's ``wall_s`` ends when its
outputs are numpy arrays on the host, which waits for the card.

Each bucket's traces are made where its sweep runs (``api.tracegen``):
on the card, the host lowers each scenario's warps and the CUDA sampler
(``repro_torch.kernels.tracegen``) draws the cells into device memory;
on the CPU, and for every sweep on a mesh, the numpy sampler draws them
on the host. ``keep_traces=True`` brings a card's trace to the host
once, one copy a key, so ``ResultSet.trace`` returns numpy arrays on
every path.
``engine="serving"`` runs the open-loop serving simulator
(``repro_torch.serving.sim``), which is host-side numpy as in the
reference: its buckets run on the host whatever ``device`` is, though a
run still needs the card unless ``device="cpu"`` is given.

``mesh`` (a ``repro_torch.sharding.Mesh``, e.g.
``launch.make_local_mesh``) and ``mesh_axes`` (policy, seed, warp) place
each bucket's sweep on a mesh of devices in this process; the plan
compiler resolves the placement per bucket (the replication fallback
applied), and the sharded run is bitwise the unsharded one. With a mesh
the runs go to the mesh's devices; ``device`` must then name the mesh's
device type, or stay ``None``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import sharding as SH
from repro_torch import spans as SP
from repro_torch.api.results import ResultBlock, ResultSet
from repro_torch.api.scenario import Scenario, Shape
from repro_torch.core.engine import (SimParams, mesh_device, resolve_device,
                                     simulate_sweep, validate_engine_args,
                                     validate_mesh_args)
from repro_torch.policy import Policy
from repro_torch.serving.sim import (POOL_BACKENDS, generate_serving,
                                     simulate_serving)

_TRACE_KEYS = ("lines", "pcs", "compute_gap", "archetype", "oracle_wtype")


def _join(parts):
    """The scenarios' arrays (numpy, or tensors on one device) stacked on
    the seed axis; a lone part as it is."""
    if len(parts) == 1:
        return parts[0]
    if torch.is_tensor(parts[0]):
        return torch.cat(parts)
    return np.concatenate(parts)


@dataclasses.dataclass(frozen=True)
class PlanCall:
    """One emitted ``simulate_sweep`` call: a (shape, engine) bucket.
    Serving buckets run the (host-side) serving simulator instead; their
    shape is ``(-1, max_slots, n_requests)``.

    ``mesh`` + the three axis fields are the bucket's resolved placement
    (``None`` everywhere without a mesh): a policy count, seed-stack size
    or warp count the mesh axes do not divide resolves to ``None`` here,
    so ``describe()`` and ``compile_key`` show what will shard."""
    shape: Shape                       # (n_instr, n_warps, lines_per_instr)
    engine: str
    wave_size: Optional[int]
    scan_backend: str
    cache_backend: str
    scenarios: Tuple[Scenario, ...]    # seed blocks stack in this order
    mesh: Optional[SH.Mesh] = None
    policy_axes: SH.MeshAxes = None
    seed_axes: SH.MeshAxes = None
    warp_axes: SH.MeshAxes = None

    @property
    def flat(self) -> int:
        """Stacked trace count of the call (sum of scenario seed counts)."""
        return sum(s.n_seeds for s in self.scenarios)

    def compile_key(self, n_policies: int, prm: SimParams) -> tuple:
        """The call's signature: two calls with equal keys run the same
        shapes, knobs and placement (the reference's jit compile key)."""
        return (self.shape, self.flat, n_policies, self.engine,
                self.wave_size, self.scan_backend, self.cache_backend, prm,
                self.mesh, self.policy_axes, self.seed_axes,
                self.warp_axes)

    def execute_serving(self, exp: "Experiment") -> ResultBlock:
        """Run the serving simulator over this bucket, on the host: every
        (scenario, seed) request stream under every policy, metrics
        stacked to the standard ``[P, F]`` layout. One stream is
        generated per entry and shared across policies, so an A/B always
        compares on the IDENTICAL arrival sequence."""
        t0 = time.perf_counter()
        entries: List[Tuple[str, int]] = []
        cols: List[List[Dict[str, float]]] = []   # [F][P] metric dicts
        for s in self.scenarios:
            for seed in s.seeds:
                reqs = generate_serving(s.spec, seed)
                entries.append((s.name, seed))
                cols.append([simulate_serving(
                    reqs, s.spec, policy=pol,
                    pool_backend=exp.pool_backend)["metrics"]
                    for pol in exp.policies])
        metrics = {k: np.asarray(
            [[cols[f][p][k] for f in range(len(entries))]
             for p in range(len(exp.policies))], np.float64)
            for k in cols[0][0]}
        return ResultBlock(tuple(entries), metrics,
                           time.perf_counter() - t0)

    def execute_sweep(self, exp: "Experiment", j: int,
                      keep_traces: bool) -> ResultBlock:
        """Run this bucket, the plan's ``j``-th: its traces, one
        ``simulate_sweep`` call, the outputs on the host.

        The traces are made where the sweep runs: without a mesh on its
        device (the CUDA sampler's cells stay on the card), with a mesh
        on the host, so that each block moves only its own part."""
        n_instr, n_warps, lanes = self.shape
        at = resolve_device(exp.device) if self.mesh is None else None
        with SP.span("api.tracegen", j):
            parts = [s.materialize(at) for s in self.scenarios]
            # a bucket may mix constant-intensity scenarios (scalar gap
            # per seed, [S]) with phased ones ([S, I]): broadcast the
            # scalars so the stacked axis is uniform
            if any(p["compute_gap"].ndim == 2 for p in parts):
                for p in parts:
                    g = p["compute_gap"]
                    if g.ndim == 1:
                        p["compute_gap"] = np.broadcast_to(
                            g[:, None], (g.shape[0], n_instr))
            tr = {k: _join([p[k] for p in parts]) for k in _TRACE_KEYS}
        t0 = time.perf_counter()
        with SP.span("api.simulate", j):
            out = simulate_sweep(
                tr["lines"], tr["pcs"], tr["compute_gap"], exp.policies,
                n_warps=n_warps, lanes=lanes, prm=exp.prm,
                engine=self.engine, wave_size=self.wave_size,
                scan_backend=self.scan_backend,
                cache_backend=self.cache_backend,
                oracle_types=tr["oracle_wtype"], mesh=self.mesh,
                policy_axes=self.policy_axes, seed_axes=self.seed_axes,
                warp_axes=self.warp_axes, device=exp.device)
        # [P, F, ...] on the host: the copy waits for the card
        with SP.span("api.results", j):
            out = {k: v.cpu().numpy() for k, v in out.items()}
        wall = time.perf_counter() - t0
        entries = tuple((s.name, seed) for s in self.scenarios
                        for seed in s.seeds)
        traces = None
        if keep_traces:     # one copy to the host a key
            host = {k: v.cpu().numpy() if torch.is_tensor(v) else v
                    for k, v in tr.items()}
            traces = tuple({k: host[k][f] for k in _TRACE_KEYS}
                           for f in range(self.flat))
        return ResultBlock(entries, out, wall, traces)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Compiled experiment: the minimal list of calls to make."""
    experiment: "Experiment"
    calls: Tuple[PlanCall, ...]

    @property
    def n_calls(self) -> int:
        """Calls to make — one per (trace-shape, engine) bucket, so this
        IS the bucket count."""
        return len(self.calls)

    @property
    def n_executables(self) -> int:
        """Distinct call signatures (``PlanCall.compile_key``)."""
        exp = self.experiment
        return len({c.compile_key(len(exp.policies), exp.prm)
                    for c in self.calls})

    def describe(self) -> str:
        exp = self.experiment
        lines = [f"plan[{exp.name}]: {len(exp.scenarios)} scenarios x "
                 f"{len(exp.policies)} policies -> {self.n_calls} call(s), "
                 f"{self.n_executables} executable(s)"]
        for c in self.calls:
            i, w, l = c.shape
            names = ", ".join(f"{s.name}x{s.n_seeds}" for s in c.scenarios)
            if c.engine == "serving":
                lines.append(f"  [serving] slots={w} requests={l} "
                             f"flat={c.flat}: {names}")
            else:
                shard = ""
                if c.mesh is not None:
                    shard = (f" sharded(policy={c.policy_axes} "
                             f"seed={c.seed_axes} warp={c.warp_axes})")
                lines.append(f"  [{c.engine}] shape I={i} W={w} L={l} "
                             f"flat={c.flat}{shard}: {names}")
        return "\n".join(lines)

    def execute(self, keep_traces: bool = False) -> ResultSet:
        """Materialize traces and run every planned call."""
        exp = self.experiment
        if exp.mesh is None:
            resolve_device(exp.device)   # the card, unless device="cpu"
        else:
            mesh_device(exp.mesh, exp.device)
        blocks: List[ResultBlock] = []
        with SP.span("api.execute"):
            for j, call in enumerate(self.calls):
                if call.engine == "serving":
                    blocks.append(call.execute_serving(exp))
                else:
                    blocks.append(call.execute_sweep(exp, j, keep_traces))
        meta = {"experiment": exp.name, "engine": exp.engine,
                "n_calls": self.n_calls,
                "n_executables": self.n_executables}
        return ResultSet([p.name for p in exp.policies], blocks, meta)


@dataclasses.dataclass(frozen=True)
class Experiment:
    """Scenarios × policies × engine options — the one front door.

    ``run()`` compiles the plan and executes it; ``compile()`` exposes
    the plan for inspection (bucketing, call count) without
    materializing any traces. ``device`` is where the simulations run:
    ``None`` is the card (raising without one), ``"cpu"`` the plain
    PyTorch versions. ``engine="serving"`` buckets run on the host
    whatever the device (the simulator is host numpy, as in the
    reference); the device check holds for them all the same.
    """
    name: str
    scenarios: Tuple[Scenario, ...]
    policies: Tuple[Policy, ...]
    engine: str = "event"
    wave_size: Optional[int] = None
    #: wavefront timing-pass backend (repro_torch.kernels.wavefront_scan);
    #: "auto" = the CUDA kernel for the card, the plain version on the CPU
    scan_backend: str = "auto"
    #: wavefront cache-pass backend (repro_torch.kernels.cache_pass)
    cache_backend: str = "auto"
    #: serving-engine pool-transaction backend (engine="serving" only);
    #: "auto"/"fast" = vectorized access_batch, "ref" = sequential per-key
    pool_backend: str = "auto"
    #: device mesh for sharded sweeps (``repro_torch.sharding.Mesh``, e.g.
    #: ``launch.make_local_mesh``); None = one device. Every (policy,
    #: seed) cell is an independent simulation, so the sharded run is
    #: bitwise the unsharded one.
    mesh: Optional[SH.Mesh] = None
    #: (policy, seed, warp) mesh-axis assignment: which mesh axes the
    #: policy axis, the seed-stack axis and (wavefront only) the warp
    #: axis shard over. Entries are None, an axis name, or a tuple of
    #: names; an axis that does not divide its dimension falls back to
    #: replication per bucket. Defaults (when a mesh is given) to the
    #: mesh's first two axis names for (policy, seed), no warp sharding.
    mesh_axes: Optional[Tuple] = None
    prm: SimParams = SimParams()
    #: where the simulations run (None: the card)
    device: Optional[object] = None

    def __post_init__(self):
        object.__setattr__(self, "scenarios", tuple(self.scenarios))
        object.__setattr__(self, "policies", tuple(self.policies))
        if not self.scenarios:
            raise ValueError(f"experiment {self.name!r}: needs >= 1 "
                             "scenario")
        if not self.policies:
            raise ValueError(f"experiment {self.name!r}: needs >= 1 policy")
        names = [s.name for s in self.scenarios]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"experiment {self.name!r}: duplicate scenario "
                             f"names {sorted(dupes)} — results would "
                             "collide; pass name= to disambiguate")
        pnames = [p.name for p in self.policies]
        pdupes = {n for n in pnames if pnames.count(n) > 1}
        if pdupes:
            raise ValueError(f"experiment {self.name!r}: duplicate policy "
                             f"names {sorted(pdupes)}")
        if self.mesh_axes is not None and self.mesh is None:
            raise ValueError(f"experiment {self.name!r}: mesh_axes given "
                             "without a mesh; pass mesh= as well")
        if self.mesh is not None:
            if self.engine == "serving":
                raise ValueError(
                    f"experiment {self.name!r}: engine='serving' runs "
                    "host-side and does not take a mesh")
            axes = self.mesh_axes
            if axes is None:
                names = tuple(self.mesh.axis_names)
                axes = (names[0], names[1] if len(names) > 1 else None,
                        None)
            axes = tuple(axes) + (None,) * (3 - len(axes))
            if len(axes) != 3:
                raise ValueError(
                    f"experiment {self.name!r}: mesh_axes must be up to "
                    "3 entries (policy, seed, warp); got "
                    f"{self.mesh_axes!r}")
            object.__setattr__(self, "mesh_axes", axes)
            validate_mesh_args(self.mesh, *axes, engine=self.engine)
        serving = [s.name for s in self.scenarios if s.is_serving]
        if self.engine == "serving":
            if len(serving) != len(self.scenarios):
                raise ValueError(
                    f"experiment {self.name!r}: engine='serving' takes "
                    "only serving scenarios (Scenario.serving)")
            if self.pool_backend not in POOL_BACKENDS:
                raise ValueError(
                    f"experiment {self.name!r}: unknown pool_backend "
                    f"{self.pool_backend!r}; choose from {POOL_BACKENDS}")
        else:
            if serving:
                raise ValueError(
                    f"experiment {self.name!r}: serving scenarios "
                    f"{serving} need engine='serving'")
            validate_engine_args(self.engine, self.wave_size,
                                 self.scan_backend, self.cache_backend)

    def compile(self) -> Plan:
        """Bucket scenarios by trace shape; one PlanCall per bucket.

        With a mesh, each bucket's placement is resolved here against
        its policy count, seed-stack size and warp count (the
        replication fallback applied)."""
        buckets: Dict[Shape, List[Scenario]] = {}
        for s in self.scenarios:
            buckets.setdefault(s.shape, []).append(s)
        calls = []
        for shape, scens in buckets.items():
            mesh = pol_ax = seed_ax = warp_ax = None
            if self.mesh is not None:
                mesh = self.mesh
                p_want, s_want, w_want = self.mesh_axes
                flat = sum(s.n_seeds for s in scens)
                pol_ax = SH.resolve_axes(mesh, p_want, len(self.policies))
                seed_ax = SH.resolve_axes(mesh, s_want, flat)
                warp_ax = SH.resolve_axes(mesh, w_want, shape[1])
            calls.append(
                PlanCall(shape, self.engine, self.wave_size,
                         self.scan_backend, self.cache_backend,
                         tuple(scens), mesh, pol_ax, seed_ax, warp_ax))
        return Plan(self, tuple(calls))

    def run(self, keep_traces: bool = False) -> ResultSet:
        with SP.span("api.run"):
            with SP.span("api.compile"):
                plan = self.compile()
            return plan.execute(keep_traces=keep_traces)

    # convenience for quick derivative experiments
    def with_(self, **changes) -> "Experiment":
        return dataclasses.replace(self, **changes)


def run(scenarios: Sequence[Scenario], policies: Sequence[Policy],
        engine: str = "event", wave_size: Optional[int] = None,
        scan_backend: str = "auto", cache_backend: str = "auto",
        prm: SimParams = SimParams(), mesh=None, mesh_axes=None,
        name: str = "adhoc", keep_traces: bool = False,
        device=None) -> ResultSet:
    """One-shot helper: ``api.run(scenarios, policies)`` -> ResultSet."""
    return Experiment(name, tuple(scenarios), tuple(policies), engine,
                      wave_size, scan_backend, cache_backend, mesh=mesh,
                      mesh_axes=mesh_axes, prm=prm,
                      device=device).run(keep_traces=keep_traces)
