"""Backend-gated wavefront cache pass.

``wave_cache_pass`` services one wave's B×L requests — bypass decision,
L2 tag lookup, RRIP fill/eviction, EAF + PC-table bookkeeping, and the
classifier observe — and returns the advanced state plus the per-lane
record tuple the timing pass consumes. Backends:

  * ``"ref"``  — the plain PyTorch lane loop (``ref.py``), on any device.
  * ``"cuda"`` — the hand-written Hopper kernel ``csrc/wave_cache.cu``:
    one launch runs the whole wave, lanes inside the kernel, with the
    cache state in shared memory where ``plan_wave_cache`` finds that it
    fits (else in global memory). It takes CUDA tensors only and raises
    otherwise.
  * ``"auto"`` — the kernel for CUDA tensors, the plain version for CPU
    tensors.

The kernel is bitwise equal to the plain version on state, classifier
rows and records; ``chip_smoke.py`` checks that on the card. The
reference's ``fused`` and ``pallas`` backends are XLA:CPU and TPU forms
and are not ported: the kernel takes their place.
"""
from __future__ import annotations

import array
import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import classifier as CLF
from repro_torch.core import warp_types as WT
from repro_torch.core.engine.state import CACHE_FIELDS, SimParams, SimState
from repro_torch.kernels import _build
from repro_torch.kernels._build import Kernel, stream_of
from repro_torch.kernels.cache_pass import ref as _ref
from repro_torch.policy import PolicyArrays

F32 = torch.float32
I32 = torch.int32
BOOL = torch.bool

BACKENDS = _build.BACKENDS

#: widest wave the kernel takes (16 slots per thread of a 1024-thread
#: block): the default wave of the reference's widest trace, WIDE64K
#: (65,536 warps, waves of W/4)
KERNEL_MAX_B = 16384
#: dynamic shared memory one block may have on an H100 (232,448 bytes,
#: the opt-in maximum per block) less 1 KB kept for the kernel's static
#: shared variables
SMEM_BUDGET = 232448 - 1024

_V, _I = ctypes.c_void_p, ctypes.c_int
WAVE_CACHE = Kernel("wave_cache", [_V, _V, _V] + [_I] * 4 + [_V])


def resolve_backend(backend: str, device: torch.device) -> str:
    """``"auto"`` -> ``"cuda"`` for CUDA tensors, ``"ref"`` for CPU ones;
    ``"cuda"`` on a CPU tensor raises."""
    return _build.resolve_backend("cache", backend, device)


_STATE_FIELDS = CACHE_FIELDS
_CLF_FIELDS = CLF.ClassifierState._fields
_PA_FIELDS = ("bypass_sel", "ins_sel", "sched_medic", "rand_p", "label_sel",
              "reclass_interval", "probe_interval")


def _r4(n: int) -> int:
    """``n`` ints rounded up to whole 16-byte words."""
    return (n + 3) & ~3


class WaveCachePlan(NamedTuple):
    """How the kernel runs one wave: ``resident`` keeps the cache state in
    shared memory for the whole wave (else it lives in the outputs),
    ``smem_bytes`` of dynamic shared memory, one block of ``threads`` with
    ``slots_per_thread`` slots each."""
    resident: bool
    smem_bytes: int
    threads: int
    slots_per_thread: int


@functools.lru_cache(maxsize=64)
def plan_wave_cache(prm: SimParams, b: int, resident=None) -> WaveCachePlan:
    """The kernel's instance for waves of ``b`` slots under ``prm``, from
    the shapes alone: the shared-memory-resident one wherever the four
    per-set pointer tables and the whole state (tags, rrip, meta, EAF, PC
    tables; each array from a 16-byte start) fit in ``SMEM_BUDGET``, else
    the one that keeps the state in global memory. ``resident=False``
    asks for the global one whatever the shapes, ``resident=True`` raises
    where the state does not fit. Raises where even the pointer tables
    do not fit, or ``b`` is outside 1..KERNEL_MAX_B. The launch takes the
    plan's threads, slots a thread and bytes as they are."""
    if not 1 <= b <= KERNEL_MAX_B:
        raise ValueError(f"wave_cache kernel takes 1..{KERNEL_MAX_B} "
                         f"slots per wave, got {b}")
    tables = 4 * 4 * _r4(prm.sets)
    state = 4 * (3 * _r4(prm.sets * prm.ways) + _r4(prm.eaf_bits)
                 + 3 * _r4(prm.pc_entries))
    if tables > SMEM_BUDGET:
        raise ValueError(f"wave_cache kernel: {prm.sets} sets need "
                         f"{tables} bytes of pointer tables, over the "
                         f"{SMEM_BUDGET} bytes of shared memory a block has")
    fits = tables + state <= SMEM_BUDGET
    if resident is None:
        resident = fits
    elif resident and not fits:
        raise ValueError(f"wave_cache: the state of {prm} does not fit in "
                         "shared memory")
    # 1, 2 or 4 slots a thread on up to 512 threads (128 registers each),
    # else 8 or 16 on 1024 (64 registers; at 16 the slots' registers spill)
    mid = -(-b // 512)
    spt = 1 if mid == 1 else 2 if mid == 2 else 4 if mid <= 4 \
        else 8 if mid <= 16 else 16
    threads = -(-b // 32) * 32 if spt == 1 else 512 if spt < 8 else 1024
    return WaveCachePlan(bool(resident),
                         tables + state if resident else tables, threads, spt)


def _a16(n: int) -> int:
    return (n + 15) & ~15


def record_views(lanes: int, b: int, device) -> tuple:
    """The nine records [L, B] ``(t_arr, addr, valid, byp, use_l2, hit, hp,
    victim_type, ev_valid)``, fresh, as views of one byte buffer, each at
    a 16-byte start: the three 4-byte records, then the six bools."""
    n = lanes * b
    s4, s1 = _a16(4 * n), _a16(n)
    buf = torch.empty(3 * s4 + 6 * s1, dtype=BOOL, device=device)
    w = buf.view(I32).as_strided((3, lanes, b), (s4 // 4, b, 1)).unbind(0)
    o = buf.as_strided((6, lanes, b), (s1, b, 1), 3 * s4).unbind(0)
    return (w[0].view(F32), w[1], o[0], o[1], o[2], o[3], o[4], w[2], o[5])


def state_views(prm: SimParams, b: int, device) -> tuple:
    """The new cache state (a dict of ``_STATE_FIELDS``) and classifier
    rows [B] (a ``ClassifierState``), fresh, as views of one int32
    buffer, each at a 16-byte start (the arrays first, the two scalars
    last)."""
    sw, pc = prm.sets * prm.ways, prm.pc_entries
    n = (sw, sw, sw, prm.eaf_bits, pc, pc, pc, b, b, b, b, b, b, 1, 1)
    size = [_r4(x) for x in n]
    buf = torch.empty(sum(size), dtype=I32, device=device)
    v = list(buf.split_with_sizes(size))
    for i in range(13):
        if size[i] != n[i]:
            v[i] = v[i][:n[i]]
    new = dict(zip(("tags", "rrip", "meta_type"),
                   (x.view(prm.sets, prm.ways) for x in v[:3])))
    new.update(eaf=v[3], eaf_gen=v[13][0], eaf_ctr=v[14][0], pc_hits=v[4],
               pc_acc=v[5], pc_req=v[6])
    return new, CLF.ClassifierState(v[7], v[8], v[9], v[10].view(F32),
                                    v[11], v[12])


class _Layout(NamedTuple):
    """What a launch needs that depends on ``(prm, lanes, b, device)``."""
    plan: WaveCachePlan
    dims: ctypes.Array
    consts: ctypes.Array
    specs: tuple        # (dtype, shape) of the 28 inputs, in pointer order
    expect: list        # (dtype, shape, device index, contiguous) of each


@functools.lru_cache(maxsize=64)
def _layout(prm: SimParams, lanes: int, b: int, dev: int = -1) -> _Layout:
    sw, pc = (prm.sets, prm.ways), (prm.pc_entries,)
    specs = ((I32, (lanes, b)), (I32, (b,)), (I32, (b,)), (BOOL, (b,)),
             (BOOL, (b,)), (F32, (b,)), (F32, (5,)), (F32, (3,)), (F32, ()),
             (F32, ()), (F32, (3,)), (F32, ()), (F32, ()),
             (I32, sw), (I32, sw), (I32, sw), (I32, (prm.eaf_bits,)),
             (I32, ()), (I32, ()), (I32, pc), (I32, pc), (I32, pc),
             *((F32 if f == "ratio" else I32, (b,)) for f in _CLF_FIELDS))
    return _Layout(
        plan=plan_wave_cache(prm, b),
        dims=(ctypes.c_int * 8)(b, lanes, prm.sets, prm.ways, prm.eaf_bits,
                                prm.pc_entries, prm.rrip_max,
                                prm.eaf_capacity),
        # float32 roundings of the reference's Python doubles
        consts=(ctypes.c_float * 7)(
            prm.lane_skew, float(prm.sampling_interval),
            float(prm.probe_interval), prm.mostly_hit_threshold,
            prm.mostly_miss_threshold, WT._EPS, 1.0 - WT._EPS),
        specs=specs,
        expect=[(dt, torch.Size(sh), dev, True) for dt, sh in specs])


_NAMES = (("addr_lb", "pc_b", "owt_b", "slot_ok", "tokens_b", "t0")
          + tuple(f"pa.{f}" for f in _PA_FIELDS)
          + tuple(f"st.{f}" for f in _STATE_FIELDS)
          + tuple(f"clf_b0.{f}" for f in _CLF_FIELDS))


def wave_cache_cuda(st: SimState, clf_b0: CLF.ClassifierState, tokens_b,
                    t0, addr_lb, pc_b, owt_b, slot_ok, prm: SimParams,
                    pa: PolicyArrays, *, resident=None) -> tuple:
    """The Hopper kernel: ``(st, clf_b, records)`` as
    ``wave_cache_pass_ref`` returns them, from one launch. The new cache
    state and classifier rows are fresh tensors (views of one buffer), the
    records views of another; the inputs are untouched. The instance is
    ``plan_wave_cache(prm, B, resident)``'s: ``resident=False`` asks for
    the global-state one whatever the shapes (the card tests hold both
    against the plain version), ``resident=True`` where the state does
    not fit raises."""
    if not addr_lb.is_cuda:
        raise ValueError("wave_cache_cuda needs CUDA tensors")
    lanes, b = addr_lb.shape
    lay = _layout(prm, lanes, b, addr_lb.get_device())
    plan = lay.plan if resident is None else \
        plan_wave_cache(prm, b, resident=resident)
    ins = (addr_lb, pc_b, owt_b, slot_ok, tokens_b, t0,
           *(getattr(pa, f) for f in _PA_FIELDS),
           *(getattr(st, f) for f in _STATE_FIELDS), *clf_b0)
    got = [(t.dtype, t.shape, t.get_device(), t.is_contiguous()) for t in ins]
    if got != lay.expect:
        i = next(i for i, (g, e) in enumerate(zip(got, lay.expect)) if g != e)
        raise ValueError(
            f"wave_cache: {_NAMES[i]} must be a contiguous {lay.specs[i][0]} "
            f"tensor of shape {lay.specs[i][1]} on {addr_lb.device}, got "
            f"{ins[i].dtype} {tuple(ins[i].shape)} on {ins[i].device}")
    new, clf = state_views(prm, b, addr_lb.device)
    recs = record_views(lanes, b, addr_lb.device)
    outs = (*new.values(), *clf, *recs)
    ptrs = array.array("q", [t.data_ptr() for t in ins + outs])
    WAVE_CACHE.launch(lay.dims, lay.consts, ptrs.buffer_info()[0],
                      int(plan.resident), plan.threads,
                      plan.slots_per_thread, plan.smem_bytes,
                      stream_of(addr_lb))
    return st._replace(**new), clf, recs


def wave_cache_pass(st: SimState, clf_b0: CLF.ClassifierState, tokens_b,
                    t0, addr_lb, pc_b, owt_b, slot_ok, prm: SimParams,
                    pa: PolicyArrays, *, backend: str = "auto") -> tuple:
    """One wave's cache pass under the selected backend. Returns
    ``(st, clf_b, records)``; records are the nine [L, B] arrays
    ``(t_arr, addr, valid, byp, use_l2, hit, hp, victim_type, ev_valid)``.
    """
    args = (st, clf_b0, tokens_b, t0, addr_lb, pc_b, owt_b, slot_ok, prm, pa)
    if resolve_backend(backend, addr_lb.device) == "ref":
        return _ref.wave_cache_pass_ref(*args)
    return wave_cache_cuda(*args)
