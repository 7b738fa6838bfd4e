"""Simulation engines behind one API, in torch (port of
``repro.core.engine``).

  * ``engine/wavefront.py`` — the batched round-lockstep event loop,
    whose two per-wave passes run as hand-written CUDA kernels on the
    card;
  * ``engine/state.py``     — SimParams / SimState / init_state;
  * ``engine/request.py``   — per-request math.

``simulate`` / ``simulate_sweep`` keep the reference's signatures plus
``device=``. They run on the card: the default device is ``"cuda"``, and
without a CUDA device they raise unless the caller passes
``device="cpu"`` (where the plain PyTorch versions of the kernels run).
Only ``engine="wavefront"`` is ported; the exact ``event`` engine is the
next slice (ROADMAP A3), so the reference's default ``engine="event"``
raises here. The reference vmaps over policies and seeds; the port runs
those as a Python loop of independent simulations and stacks the outputs
as ``[P]`` or ``[P, S]``. ``mesh``/``*_axes`` are not ported (ROADMAP A8).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.core.engine import wavefront as _wavefront
from repro_torch.core.engine.state import (N_QBINS, SimParams, SimState,
                                           init_state, state_from_numpy)
from repro_torch.kernels.cache_pass.ops import BACKENDS as CACHE_BACKENDS
from repro_torch.kernels.wavefront_scan.ops import BACKENDS as SCAN_BACKENDS
from repro_torch.policy import Policy, policy_row, stack_policies

ENGINES = ("event", "wavefront")


def validate_engine_args(engine: str, wave_size: Optional[int] = None,
                         scan_backend: str = "auto",
                         cache_backend: str = "auto") -> None:
    """Front-door validation shared by ``simulate``/``simulate_sweep``.

    Raises ``ValueError`` for an unknown or not-yet-ported engine, a bad
    ``wave_size``, and an unknown ``scan_backend``/``cache_backend``
    (allowed: ``("auto", "ref", "cuda")``), before any work starts."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    if engine == "event":
        raise ValueError(
            "engine='event' is not ported to repro_torch yet (ROADMAP A3, "
            "the next slice); use engine='wavefront'")
    if wave_size is not None:
        if wave_size != int(wave_size):
            raise ValueError(
                f"wave_size must be an integer, got {wave_size!r}")
        if wave_size < 1:
            raise ValueError(f"wave_size must be >= 1, got {wave_size!r}")
    if scan_backend not in SCAN_BACKENDS:
        raise ValueError(
            f"unknown scan_backend {scan_backend!r}; choose from "
            f"{SCAN_BACKENDS}")
    if cache_backend not in CACHE_BACKENDS:
        raise ValueError(
            f"unknown cache_backend {cache_backend!r}; choose from "
            f"{CACHE_BACKENDS}")


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
    [S, I] for seed-stacked traces).
    """
    validate_engine_args(engine, wave_size, scan_backend, cache_backend)
    dev = resolve_device(device)
    pa = stack_policies(policies, dev)
    oracle = _oracle_or_zeros(oracle_types, trace_lines, policies)
    lines = _as(trace_lines, torch.int32, dev)
    pcs = _as(trace_pcs, torch.int32, dev)
    gap = _as(compute_gap, torch.float32, dev)
    orc = _as(oracle, torch.int32, dev)
    kw = dict(n_warps=n_warps, lanes=lanes, prm=prm, wave_size=wave_size,
              scan_backend=scan_backend, cache_backend=cache_backend)
    seeded = lines.ndim == 4
    rows = []
    for p in range(len(policies)):
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
