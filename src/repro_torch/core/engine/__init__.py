"""Simulation engines behind one API, in torch (port of
``repro.core.engine``).

  * ``engine/event.py``     — the exact discrete-event loop (one
    earliest-ready warp per step; O(I·W·L) sequential), whose loop runs
    as one hand-written CUDA kernel on the card;
  * ``engine/wavefront.py`` — the batched round-lockstep event loop,
    whose two per-wave passes run as hand-written CUDA kernels on the
    card;
  * ``engine/state.py``     — SimParams / SimState / init_state;
  * ``engine/request.py``   — per-request math.

``simulate`` / ``simulate_sweep`` keep the reference's signatures plus
``device=``. They run on the card: the default device is ``"cuda"``, and
without a CUDA device they raise unless the caller passes
``device="cpu"`` (where the plain PyTorch versions of the kernels run).
The default engine is ``"event"``, as in the reference. The reference
vmaps over policies and seeds; the event engine runs all P·S simulations
of a call in one loop (one kernel launch on the card), the wavefront
engine as a Python loop of independent simulations; both stack the
outputs as ``[P]`` or ``[P, S]``.

``mesh`` + ``policy_axes`` / ``seed_axes`` / ``warp_axes`` place a sweep
on a ``repro_torch.sharding.Mesh`` of torch devices, in this one
process: the policy and seed axes cut the sweep into blocks of
independent simulations, each run on its block's mesh device (one
event-loop launch a block); the warp axes cut each wavefront
simulation's warps into shards (``wavefront.simulate_core``'s
sharded-warp path). Outputs end on the mesh's first device, stacked in
the unsharded order, bitwise equal to the unsharded call.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import torch

from repro_torch import sharding as SH
from repro_torch.core.engine import event as _event
from repro_torch.core.engine import wavefront as _wavefront
from repro_torch.core.engine.state import (N_QBINS, SimParams, SimState,
                                           init_state, state_from_numpy)
# the kernels' backend names from ``_build``, which imports no engine
# module: the kernel packages import ``core.engine`` in turn
from repro_torch.kernels._build import BACKENDS as CACHE_BACKENDS
from repro_torch.kernels._build import BACKENDS as SCAN_BACKENDS
from repro_torch.policy import (Policy, PolicyArrays, policy_row,
                                stack_policies)

ENGINES = ("event", "wavefront")


def validate_engine_args(engine: str, wave_size: Optional[int] = None,
                         scan_backend: str = "auto",
                         cache_backend: str = "auto") -> None:
    """Front-door validation shared by ``simulate``/``simulate_sweep`` and
    the declarative ``repro_torch.api`` layer.

    Raises ``ValueError`` for an unknown engine, a bad ``wave_size``, an
    unknown ``scan_backend``/``cache_backend`` (allowed: ``("auto",
    "ref", "cuda")``), and — instead of silently ignoring it — for a
    ``wave_size`` or a non-default backend passed to an engine that does
    not consume one (only ``"wavefront"`` does), before any work starts."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    if wave_size is not None:
        if engine != "wavefront":
            raise ValueError(
                f"wave_size={wave_size!r} is only meaningful with "
                f"engine='wavefront'; engine={engine!r} would silently "
                f"ignore it")
        if wave_size != int(wave_size):
            raise ValueError(
                f"wave_size must be an integer, got {wave_size!r}")
        if wave_size < 1:
            raise ValueError(f"wave_size must be >= 1, got {wave_size!r}")
    for kind, backend, allowed in (("scan", scan_backend, SCAN_BACKENDS),
                                   ("cache", cache_backend, CACHE_BACKENDS)):
        if backend not in allowed:
            raise ValueError(
                f"unknown {kind}_backend {backend!r}; choose from {allowed}")
        if backend != "auto" and engine != "wavefront":
            raise ValueError(
                f"{kind}_backend={backend!r} is only meaningful with "
                f"engine='wavefront'; engine={engine!r} would silently "
                f"ignore it")


def validate_mesh_args(mesh, policy_axes=None, seed_axes=None,
                       warp_axes=None, engine: str = "event") -> None:
    """Front-door validation for the multi-device sweep knobs.

    Mesh-axis assignments without a mesh, axis names the mesh does not
    carry, one mesh axis claimed by two sweep axes, and warp-axis
    sharding on an engine without a sharded-warp path all fail here with
    a one-line ``ValueError``, before any placement. (Divisibility is not
    validated: an axis product that does not divide its dimension falls
    back to replication, ``sharding.resolve_axes``.)
    """
    named = {"policy_axes": SH.norm_axes(policy_axes),
             "seed_axes": SH.norm_axes(seed_axes),
             "warp_axes": SH.norm_axes(warp_axes)}
    if mesh is None:
        given = [k for k, v in named.items() if v is not None]
        if given:
            raise ValueError(f"{', '.join(given)} given without a mesh; "
                             "pass mesh= as well")
        return
    present = set(mesh.axis_names)
    for k, axes in named.items():
        for a in axes or ():
            if a not in present:
                raise ValueError(
                    f"{k} names mesh axis {a!r} but the mesh only has "
                    f"axes {tuple(mesh.axis_names)}")
    claimed: dict = {}
    for k, axes in named.items():
        for a in axes or ():
            if a in claimed:
                raise ValueError(
                    f"mesh axis {a!r} is claimed by both {claimed[a]} "
                    f"and {k}; each sweep axis needs its own mesh axes")
            claimed[a] = k
    if named["warp_axes"] is not None and engine != "wavefront":
        raise ValueError(
            f"warp_axes={warp_axes!r} is only meaningful with "
            f"engine='wavefront' (the sharded-warp path); "
            f"engine={engine!r} would silently ignore it")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without a CUDA device that raises: the
    port runs on the CPU only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def mesh_device(mesh: SH.Mesh, device=None) -> torch.device:
    """The first device of ``mesh``: where a sharded call's inputs start
    and its outputs end. A ``device`` of another type than the mesh's
    raises ``ValueError``; a CUDA mesh without a card, or naming a card
    the machine does not have, raises."""
    home = mesh.devices.flat[0]
    if device is not None and torch.device(device).type != home.type:
        raise ValueError(
            f"device={device!r} is not of the mesh's device type "
            f"{home.type!r}; drop device= or pass a {home.type} device")
    resolve_device(home)
    if home.type == "cuda":
        n = torch.cuda.device_count()
        missing = sorted({str(d) for d in mesh.devices.flat
                          if (d.index or 0) >= n})
        if missing:
            raise ValueError(f"the mesh names {missing} but the machine "
                             f"has {n} card(s)")
    return home


def _on_device(dev: torch.device):
    """A context in which ``dev`` is the current CUDA device (a no-op for
    the CPU): the kernels launch on the current device, so a block of a
    sweep on another card runs under its card."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _oracle_or_zeros(oracle_types, trace_lines, policies):
    """The ground-truth label input: required when a policy reads it
    (labeling="oracle"), else a zero placeholder."""
    if oracle_types is not None:
        return oracle_types
    needs = [p.name for p in policies if p.labeling == "oracle"]
    if needs:
        raise ValueError(
            f"policies {needs} use labeling='oracle' but no oracle_types "
            "were passed; supply the trace's 'oracle_wtype' array "
            "(repro_torch.core.tracegen emits it for every spec)")
    return torch.zeros(tuple(trace_lines.shape[:-1]), dtype=torch.int32)


def _as(x, dtype, dev=None) -> torch.Tensor:
    """``x`` as a tensor of ``dtype`` on ``dev`` (``None``: where it is)."""
    return torch.as_tensor(x).to(device=dev, dtype=dtype)


def _stack(outs):
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _cat(parts: List[Dict[str, torch.Tensor]], dim: int = 0):
    """The blocks' outputs joined on ``dim``; one block's as they are."""
    if len(parts) == 1:
        return parts[0]
    return {k: torch.cat([p[k] for p in parts], dim=dim) for k in parts[0]}


def simulate(trace_lines, trace_pcs, compute_gap, *, n_warps: int,
             lanes: int, prm: SimParams, pol: Policy,
             engine: str = "event", wave_size: Optional[int] = None,
             scan_backend: str = "auto", cache_backend: str = "auto",
             oracle_types=None, mesh: Optional[SH.Mesh] = None,
             warp_axes: SH.MeshAxes = None, device=None) -> Dict[str, Any]:
    """Run one workload under one policy; returns the metrics dict (torch
    tensors on ``device``, or the mesh's first device).

    trace_lines: i32[I, W, L]; trace_pcs: i32[I, W]; compute_gap: f32
    scalar or f32[I]; oracle_types: optional i32[I, W] ground-truth labels
    — required when the policy's labeling mode is "oracle". Arrays may be
    numpy or torch. ``mesh`` + ``warp_axes`` take the wavefront engine's
    sharded-warp path (replication fallback when the axis product does
    not divide ``n_warps``); bitwise the unsharded run.
    """
    out = simulate_sweep(trace_lines, trace_pcs, compute_gap, (pol,),
                         n_warps=n_warps, lanes=lanes, prm=prm,
                         engine=engine, wave_size=wave_size,
                         scan_backend=scan_backend,
                         cache_backend=cache_backend,
                         oracle_types=oracle_types, mesh=mesh,
                         warp_axes=warp_axes, device=device)
    return {k: v[0] for k, v in out.items()}


def simulate_sweep(trace_lines, trace_pcs, compute_gap,
                   policies: Sequence[Policy], *, n_warps: int, lanes: int,
                   prm: SimParams, engine: str = "event",
                   wave_size: Optional[int] = None,
                   scan_backend: str = "auto",
                   cache_backend: str = "auto",
                   oracle_types=None, mesh: Optional[SH.Mesh] = None,
                   policy_axes: SH.MeshAxes = None,
                   seed_axes: SH.MeshAxes = None,
                   warp_axes: SH.MeshAxes = None,
                   device=None) -> Dict[str, Any]:
    """Run a whole policy sweep: one independent simulation per policy
    (and per seed), outputs stacked on a leading policy axis.

    trace_lines may be [I, W, L] (outputs get a leading axis P) or
    seed-stacked [S, I, W, L] (outputs get leading axes [P, S]);
    trace_pcs/compute_gap/oracle_types follow suit (compute_gap is [S] or
    [S, I] for seed-stacked traces). On the event engine all P·S
    simulations run in one loop: one launch of the event-loop kernel on
    the card.

    With a ``mesh``, the resolved ``policy_axes`` / ``seed_axes`` cut the
    policies and the seed stack into blocks; block (i, j) runs on the
    mesh device at index i along the policy axes and j along the seed
    axes (one event-loop launch a block), and the resolved ``warp_axes``
    shard each wavefront simulation's warps. An axis whose mesh product
    does not divide its dimension falls back to replication. ``device``
    then defaults to the mesh's first device, where the outputs end. The
    trace stays where the caller has it (numpy: the host) and each block
    or warp shard moves its own part to its device, so a sharded trace
    never sits whole on one card.
    """
    validate_engine_args(engine, wave_size, scan_backend, cache_backend)
    validate_mesh_args(mesh, policy_axes, seed_axes, warp_axes, engine)
    dev = resolve_device(device) if mesh is None \
        else mesh_device(mesh, device)
    pa = stack_policies(policies, dev)
    oracle = _oracle_or_zeros(oracle_types, trace_lines, policies)
    at = dev if mesh is None else None
    lines = _as(trace_lines, torch.int32, at)
    pcs = _as(trace_pcs, torch.int32, at)
    gap = _as(compute_gap, torch.float32, dev)
    orc = _as(oracle, torch.int32, at)
    seeded = lines.ndim == 4
    n_pol, n_seeds = len(policies), lines.shape[0] if seeded else 1
    p_res = SH.resolve_axes(mesh, policy_axes, n_pol)
    s_res = SH.resolve_axes(mesh, seed_axes, n_seeds) if seeded else None
    w_res = SH.resolve_axes(mesh, warp_axes, n_warps)
    grid = _block_grid(mesh, p_res, s_res, n_pol, n_seeds, dev)
    if engine == "event":
        if not seeded:      # one trace: a seed stack of one
            lines, pcs, gap, orc = (x.unsqueeze(0) for x in
                                    (lines, pcs, gap, orc))
        rows = []           # one {metric: [P_i, S, ...]} a policy block
        for row in grid:
            cols = []
            for b in row:
                ss, d = b.seeds, b.device
                with _on_device(d):
                    out = _event.simulate_core(
                        lines[ss].to(d), pcs[ss].to(d), gap[ss].to(d),
                        orc[ss].to(d),
                        PolicyArrays(*(a[b.policies].to(d) for a in pa)),
                        n_warps=n_warps, lanes=lanes, prm=prm)
                lead = (b.policies.stop - b.policies.start,
                        ss.stop - ss.start)
                cols.append({k: v.reshape(*lead, *v.shape[1:]).to(dev)
                             for k, v in out.items()})
            rows.append(_cat(cols, dim=1))
        out = _cat(rows)
        if not seeded:
            out = {k: v[:, 0] for k, v in out.items()}
    else:
        out = _wavefront_sweep(lines, pcs, gap, orc, pa, grid, seeded,
                               dev, n_warps=n_warps, lanes=lanes, prm=prm,
                               wave_size=wave_size,
                               scan_backend=scan_backend,
                               cache_backend=cache_backend,
                               warp_mesh=mesh if w_res is not None
                               else None, warp_axes=w_res)
    # metric names in sorted order, as the reference's jitted outputs
    return {k: out[k] for k in sorted(out)}


class Block(NamedTuple):
    """One block of a sweep: its policies and seeds, the device it runs
    on and its mesh coordinates."""
    policies: slice
    seeds: slice
    device: torch.device
    coords: Dict[str, int]


def _block_grid(mesh, p_res, s_res, n_pol: int, n_seeds: int,
                dev) -> List[List[Block]]:
    """The sweep's blocks, ``grid[i][j]`` for policy block i and seed
    block j: one block on ``dev`` without a mesh or with neither axis
    resolved."""
    if mesh is None:
        return [[Block(slice(0, n_pol), slice(0, n_seeds), dev, {})]]
    pcs, scs = SH.block_coords(mesh, p_res), SH.block_coords(mesh, s_res)
    bp, bs = n_pol // len(pcs), n_seeds // len(scs)
    return [[Block(slice(i * bp, (i + 1) * bp), slice(j * bs, (j + 1) * bs),
                   SH.block_device(mesh, pc, sc), {**pc, **sc})
             for j, sc in enumerate(scs)] for i, pc in enumerate(pcs)]


def _wavefront_sweep(lines, pcs, gap, orc, pa, grid, seeded: bool, dev,
                     **kw) -> Dict[str, Any]:
    """One wavefront simulation per (policy, seed), each on its block's
    device (its warps sharded around it when ``kw`` resolves warp axes;
    ``simulate_core`` moves the trace), stacked on ``dev``."""
    n_pol = pa.rand_p.shape[0]
    n_seeds = lines.shape[0] if seeded else 1
    bp, bs = n_pol // len(grid), n_seeds // len(grid[0])
    rows = []
    for p in range(n_pol):
        outs = []
        for s in range(n_seeds):
            b = grid[p // bp][s // bs]
            ln, pc, gp, oc = (lines[s], pcs[s], gap[s], orc[s]) if seeded \
                else (lines, pcs, gap, orc)
            with _on_device(b.device):
                out = _wavefront.simulate_core(
                    ln, pc, gp.to(b.device), oc,
                    PolicyArrays(*(a.to(b.device)
                                   for a in policy_row(pa, p))),
                    home=b.coords, **kw)
            outs.append({k: v.to(dev) for k, v in out.items()})
        rows.append(_stack(outs) if seeded else outs[0])
    return _stack(rows)


__all__ = [
    "CACHE_BACKENDS", "ENGINES", "N_QBINS", "SCAN_BACKENDS", "SimParams",
    "SimState", "init_state", "mesh_device", "resolve_device", "simulate",
    "simulate_sweep", "state_from_numpy", "validate_engine_args",
    "validate_mesh_args",
]
