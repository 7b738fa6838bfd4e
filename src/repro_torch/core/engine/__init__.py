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
outputs as ``[P]`` or ``[P, S]``. ``mesh``/``*_axes`` are not ported
(ROADMAP A8).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.core.engine import event as _event
from repro_torch.core.engine import wavefront as _wavefront
from repro_torch.core.engine.state import (N_QBINS, SimParams, SimState,
                                           init_state, state_from_numpy)
# the kernels' backend names from ``_build``, which imports no engine
# module: the kernel packages import ``core.engine`` in turn
from repro_torch.kernels._build import BACKENDS as CACHE_BACKENDS
from repro_torch.kernels._build import BACKENDS as SCAN_BACKENDS
from repro_torch.policy import Policy, policy_row, stack_policies

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


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without a CUDA device that raises: the
    port runs on the CPU only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


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


def _as(x, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=dtype)


def _stack(outs):
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def simulate(trace_lines, trace_pcs, compute_gap, *, n_warps: int,
             lanes: int, prm: SimParams, pol: Policy,
             engine: str = "event", wave_size: Optional[int] = None,
             scan_backend: str = "auto", cache_backend: str = "auto",
             oracle_types=None, device=None) -> Dict[str, Any]:
    """Run one workload under one policy; returns the metrics dict (torch
    tensors on ``device``).

    trace_lines: i32[I, W, L]; trace_pcs: i32[I, W]; compute_gap: f32
    scalar or f32[I]; oracle_types: optional i32[I, W] ground-truth labels
    — required when the policy's labeling mode is "oracle". Arrays may be
    numpy or torch.
    """
    out = simulate_sweep(trace_lines, trace_pcs, compute_gap, (pol,),
                         n_warps=n_warps, lanes=lanes, prm=prm,
                         engine=engine, wave_size=wave_size,
                         scan_backend=scan_backend,
                         cache_backend=cache_backend,
                         oracle_types=oracle_types, device=device)
    return {k: v[0] for k, v in out.items()}


def simulate_sweep(trace_lines, trace_pcs, compute_gap,
                   policies: Sequence[Policy], *, n_warps: int, lanes: int,
                   prm: SimParams, engine: str = "event",
                   wave_size: Optional[int] = None,
                   scan_backend: str = "auto",
                   cache_backend: str = "auto",
                   oracle_types=None, device=None) -> Dict[str, Any]:
    """Run a whole policy sweep: one independent simulation per policy
    (and per seed), outputs stacked on a leading policy axis.

    trace_lines may be [I, W, L] (outputs get a leading axis P) or
    seed-stacked [S, I, W, L] (outputs get leading axes [P, S]);
    trace_pcs/compute_gap/oracle_types follow suit (compute_gap is [S] or
    [S, I] for seed-stacked traces). On the event engine all P·S
    simulations run in one loop: one launch of the event-loop kernel on
    the card.
    """
    validate_engine_args(engine, wave_size, scan_backend, cache_backend)
    dev = resolve_device(device)
    pa = stack_policies(policies, dev)
    oracle = _oracle_or_zeros(oracle_types, trace_lines, policies)
    lines = _as(trace_lines, torch.int32, dev)
    pcs = _as(trace_pcs, torch.int32, dev)
    gap = _as(compute_gap, torch.float32, dev)
    orc = _as(oracle, torch.int32, dev)
    seeded = lines.ndim == 4
    if engine == "event":
        if not seeded:      # one trace: a seed stack of one
            lines, pcs, gap, orc = (x.unsqueeze(0) for x in
                                    (lines, pcs, gap, orc))
        out = _event.simulate_core(lines, pcs, gap, orc, pa,
                                   n_warps=n_warps, lanes=lanes, prm=prm)
        lead = (len(policies), lines.shape[0]) if seeded \
            else (len(policies),)
        out = {k: v.reshape(*lead, *v.shape[1:]) for k, v in out.items()}
    else:
        out = _wavefront_sweep(lines, pcs, gap, orc, pa, len(policies),
                               n_warps=n_warps, lanes=lanes, prm=prm,
                               wave_size=wave_size,
                               scan_backend=scan_backend,
                               cache_backend=cache_backend)
    # metric names in sorted order, as the reference's jitted outputs
    return {k: out[k] for k in sorted(out)}


def _wavefront_sweep(lines, pcs, gap, orc, pa, n_policies: int,
                     **kw) -> Dict[str, Any]:
    """One wavefront simulation per (policy, seed), stacked."""
    seeded = lines.ndim == 4
    rows = []
    for p in range(n_policies):
        pa_p = policy_row(pa, p)
        if seeded:
            rows.append(_stack([_wavefront.simulate_core(
                lines[s], pcs[s], gap[s], orc[s], pa_p, **kw)
                for s in range(lines.shape[0])]))
        else:
            rows.append(_wavefront.simulate_core(lines, pcs, gap, orc, pa_p,
                                                 **kw))
    return _stack(rows)


__all__ = [
    "CACHE_BACKENDS", "ENGINES", "N_QBINS", "SCAN_BACKENDS", "SimParams",
    "SimState", "init_state", "resolve_device", "simulate",
    "simulate_sweep", "state_from_numpy", "validate_engine_args",
]
