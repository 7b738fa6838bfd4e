"""Backend-gated event loop: a whole ``simulate_sweep`` bucket of the exact
event engine.

``event_loop`` runs the I·W event steps of N = P·S simulations and
returns their final state. Backends:

  * ``"ref"``  — the plain version, ``core/engine/event.py``'s eager loop
    (one batched op per step of the reference's scalar loop), on any
    device.
  * ``"cuda"`` — the hand-written Hopper kernel ``csrc/event_loop.cu``:
    one launch, one block of one warp per simulation, the cache state and
    the per-warp rows in shared memory where ``plan_event_loop`` finds
    that they fit (else in global memory). It takes CUDA tensors only and
    raises otherwise.
  * ``"auto"`` — the kernel for CUDA tensors, the plain version for CPU
    tensors.

The kernel is bitwise equal to the plain version on every output;
``chip_smoke.py`` checks that on the card. The reference has no Pallas
kernel here: it runs the loop as a ``lax.scan``.
"""
from __future__ import annotations

import array
import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import warp_types as WT
from repro_torch.core.classifier import ClassifierState
from repro_torch.core.engine.state import N_QBINS, SimParams, SimState
from repro_torch.kernels import _build
from repro_torch.kernels._build import Kernel, stream_of

F32 = torch.float32
I32 = torch.int32

BACKENDS = _build.BACKENDS

#: dynamic shared memory one block may have on an H100 (232,448 bytes,
#: the opt-in maximum per block) less 1 KB kept for static shared variables
SMEM_BUDGET = 232448 - 1024

_V, _I = ctypes.c_void_p, ctypes.c_int
EVENT_LOOP = Kernel("event_loop", [_V, _V, _V, _I, _I, _I, _V])


def resolve_backend(backend: str, device: torch.device) -> str:
    """``"auto"`` -> ``"cuda"`` for CUDA tensors, ``"ref"`` for CPU ones;
    ``"cuda"`` on a CPU tensor raises."""
    return _build.resolve_backend("event", backend, device)


def _r4(n: int) -> int:
    """``n`` ints rounded up to whole 16-byte words."""
    return (n + 3) & ~3


class EventLoopPlan(NamedTuple):
    """Where one simulation's data lives: the cache state (``state``) and
    the per-warp rows (``rows``) in shared memory, or in the outputs in
    global memory; ``smem_bytes`` of dynamic shared memory a block."""
    state: bool
    rows: bool
    smem_bytes: int


@functools.lru_cache(maxsize=64)
def plan_event_loop(prm: SimParams, n_warps: int, state=None,
                    rows=None) -> EventLoopPlan:
    """The kernel's instance for ``n_warps`` warps under ``prm``, from the
    shapes alone: the cache state (tags, rrip, meta, EAF, the PC tables,
    the bank and channel queues) in shared memory where it fits in
    ``SMEM_BUDGET``, then the ten per-warp rows [W] where they fit beside
    it; whatever does not fit lives in global memory. ``state`` or
    ``rows`` False asks for the global layout whatever the shapes; True
    where it does not fit raises. Every shape has an instance."""
    state_b = 4 * (3 * _r4(prm.sets * prm.ways) + _r4(prm.eaf_bits)
                   + 3 * _r4(prm.pc_entries) + _r4(prm.banks)
                   + 3 * _r4(prm.dram_channels))
    rows_b = 4 * 10 * _r4(n_warps)
    fits = state_b <= SMEM_BUDGET
    if state is None:
        state = fits
    elif state and not fits:
        raise ValueError(f"event_loop: the cache state of {prm} "
                         f"({state_b} bytes) does not fit in shared memory")
    used = state_b if state else 0
    fits_rows = used + rows_b <= SMEM_BUDGET
    if rows is None:
        rows = fits_rows
    elif rows and not fits_rows:
        raise ValueError(f"event_loop: the rows of {n_warps} warps "
                         f"({rows_b} bytes) do not fit in shared memory")
    return EventLoopPlan(bool(state), bool(rows),
                         used + (rows_b if rows else 0))


_PA_FIELDS = ("bypass_sel", "ins_sel", "sched_medic", "rand_p", "label_sel",
              "reclass_interval", "probe_interval")


@functools.lru_cache(maxsize=64)
def _consts(prm: SimParams):
    # float32 roundings of the reference's Python doubles
    return (ctypes.c_float * 13)(
        prm.lane_skew, prm.l2_svc, prm.l2_lat, prm.occ_rowhit,
        prm.occ_rowmiss, prm.t_rowhit, prm.t_rowmiss,
        float(prm.sampling_interval), float(prm.probe_interval),
        prm.mostly_hit_threshold, prm.mostly_miss_threshold, WT._EPS,
        1.0 - WT._EPS)


def _outputs(n: int, n_instr: int, n_warps: int, prm: SimParams, dev):
    """Fresh output tensors in the kernel's pointer order."""
    def e(*shape, dtype=I32):
        return torch.empty(shape, dtype=dtype, device=dev)
    sw, pc, c, w = ((prm.sets, prm.ways), prm.pc_entries,
                    prm.dram_channels, n_warps)
    state = dict(tags=e(n, *sw), rrip=e(n, *sw), meta_type=e(n, *sw),
                 eaf=e(n, prm.eaf_bits), eaf_gen=e(n), eaf_ctr=e(n),
                 pc_hits=e(n, pc), pc_acc=e(n, pc), pc_req=e(n, pc),
                 bank_free=e(n, prm.banks, dtype=F32), cur_row=e(n, c),
                 hp_free=e(n, c, dtype=F32), lp_free=e(n, c, dtype=F32))
    clf = ClassifierState(hits=e(n, w), accesses=e(n, w),
                          warp_type=e(n, w), ratio=e(n, w, dtype=F32),
                          windows=e(n, w), sampled=e(n, w))
    tot = dict(tot_hits=e(n, w), tot_acc=e(n, w))
    ready, ptr = e(n, w, dtype=F32), e(n, w)
    ratio_t = torch.zeros((n, n_instr, w), dtype=F32, device=dev)
    metrics = {"qdelay_hist": e(n, N_QBINS), "qdelay_sum": e(n, dtype=F32),
               "l2_accesses": e(n), "l2_hits": e(n), "dram_accesses": e(n),
               "row_hits": e(n), "bypasses": e(n),
               "stall_cycles": e(n, dtype=F32),
               "evictions_by_type": e(n, WT.NUM_TYPES)}
    order = [*state.values(), *clf, *tot.values(), ready, ptr, ratio_t,
             *metrics.values()]
    st = SimState(clf=clf, metrics=metrics, **state, **tot)
    return st, ready, ptr, ratio_t, order


def event_loop_cuda(b, *, n_warps: int, lanes: int, prm: SimParams,
                    state=None, rows=None) -> tuple:
    """The Hopper kernel on a ``event.Bucket`` of CUDA tensors: ``(st,
    ready, ptr, ratio_t)`` as ``event.event_loop`` returns them, from one
    launch. The instance is ``plan_event_loop(prm, W, state, rows)``'s:
    False asks for the global layout of the state or the rows whatever
    the shapes (the card checks hold every instance against the plain
    version)."""
    if not b.lines.is_cuda:
        raise ValueError("event_loop_cuda needs CUDA tensors")
    s, n_instr, w, lines_l = b.lines.shape
    if w != n_warps or lines_l != lanes:
        raise ValueError(f"event_loop: trace [S, I, W, L] = "
                         f"{tuple(b.lines.shape)} against n_warps={n_warps}"
                         f", lanes={lanes}")
    n, dev = b.seed_of.shape[0], b.lines.device
    plan = plan_event_loop(prm, n_warps, state, rows)
    ins = [b.lines, b.pcs, b.oracle, b.gap, b.tokens.to(torch.uint8),
           *(getattr(b.pa, f) for f in _PA_FIELDS)]
    want = [(I32, (s, n_instr, w, lanes)), (I32, (s, n_instr, w)),
            (I32, (s, n_instr, w)), (F32, (s, n_instr)),
            (torch.uint8, (n, w)), (F32, (n, 5)), (F32, (n, 3)),
            (F32, (n,)), (F32, (n,)), (F32, (n, 3)), (F32, (n,)),
            (F32, (n,))]
    names = ["lines", "pcs", "oracle", "gap", "tokens",
             *(f"pa.{f}" for f in _PA_FIELDS)]
    for t, (dt, shape), name in zip(ins, want, names):
        _build.check_tensor("event_loop", name, t, dt, shape, dev)
    st, ready, ptr, ratio_t, order = _outputs(n, n_instr, n_warps, prm, dev)
    dims = (ctypes.c_int * 14)(
        n, s, n_instr, n_warps, lanes, prm.sets, prm.ways, prm.banks,
        prm.dram_channels, prm.eaf_bits, prm.pc_entries, prm.rrip_max,
        prm.eaf_capacity, prm.row_lines)
    ptrs = array.array("q", [t.data_ptr() for t in ins + order])
    EVENT_LOOP.launch(dims, _consts(prm), ptrs.buffer_info()[0],
                      int(plan.state), int(plan.rows), plan.smem_bytes,
                      stream_of(b.lines))
    return st, ready, ptr, ratio_t


def event_loop(b, *, n_warps: int, lanes: int, prm: SimParams,
               backend: str = "auto") -> tuple:
    """The event loop of a bucket under the selected backend. Returns
    ``(st, ready, ptr, ratio_t)``: the final state [N, ...], ready times
    and instruction pointers [N, W], the ratio snapshots [N, I, W]."""
    if resolve_backend(backend, b.lines.device) == "ref":
        from repro_torch.core.engine import event as _event
        return _event.event_loop(b, n_warps=n_warps, lanes=lanes, prm=prm)
    return event_loop_cuda(b, n_warps=n_warps, lanes=lanes, prm=prm)
