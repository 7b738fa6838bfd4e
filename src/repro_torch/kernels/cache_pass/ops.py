"""Backend-gated wavefront cache pass.

``wave_cache_pass`` services one wave's B×L requests — bypass decision,
L2 tag lookup, RRIP fill/eviction, EAF + PC-table bookkeeping, and the
classifier observe — and returns the advanced state plus the per-lane
record tuple the timing pass consumes. Backends:

  * ``"ref"``  — the plain PyTorch lane loop (``ref.py``), on any device.
  * ``"cuda"`` — the hand-written Hopper kernel ``csrc/wave_cache.cu``:
    one launch runs the whole wave, lanes inside the kernel. It takes
    CUDA tensors only and raises otherwise.
  * ``"auto"`` — the kernel for CUDA tensors, the plain version for CPU
    tensors.

The kernel is bitwise equal to the plain version on state, classifier
rows and records; ``chip_smoke.py`` checks that on the card. The
reference's ``fused`` and ``pallas`` backends are XLA:CPU and TPU forms
and are not ported: the kernel takes their place.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import classifier as CLF
from repro_torch.core import warp_types as WT
from repro_torch.core.engine.state import SimParams, SimState
from repro_torch.kernels import _build
from repro_torch.kernels._build import Kernel, ptr, stream_of
from repro_torch.kernels.cache_pass import ref as _ref
from repro_torch.policy import PolicyArrays

F32 = torch.float32
I32 = torch.int32
BOOL = torch.bool

BACKENDS = _build.BACKENDS

#: widest wave the kernel takes (8 slots per thread of a 1024-thread block)
KERNEL_MAX_B = 8192

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
WAVE_CACHE = Kernel("wave_cache",
                    [_I] * 8 + [_F] * 7 + [_V] * 6 + [_V] * 7 + [_V] * 9
                    + [_V] * 6 + [_V] * 9 + [_V])


def resolve_backend(backend: str, device: torch.device) -> str:
    """``"auto"`` -> ``"cuda"`` for CUDA tensors, ``"ref"`` for CPU ones;
    ``"cuda"`` on a CPU tensor raises."""
    return _build.resolve_backend("cache", backend, device)


_STATE_FIELDS = _ref._CACHE_FIELDS
_CLF_ORDER = ("hits", "accesses", "warp_type", "ratio", "windows", "sampled")


def wave_cache_cuda(st: SimState, clf_b0: CLF.ClassifierState, tokens_b,
                    t0, addr_lb, pc_b, owt_b, slot_ok, prm: SimParams,
                    pa: PolicyArrays) -> tuple:
    """The Hopper kernel: ``(st, clf_b, records)`` as
    ``wave_cache_pass_ref`` returns them, from one launch. The new cache
    state and classifier rows are clones of the inputs that the kernel
    updates in place; the inputs are untouched."""
    dev = addr_lb.device
    if dev.type != "cuda":
        raise ValueError("wave_cache_cuda needs CUDA tensors")
    lanes, b = addr_lb.shape
    if not 1 <= b <= KERNEL_MAX_B:
        raise ValueError(f"wave_cache kernel takes 1..{KERNEL_MAX_B} "
                         f"slots per wave, got {b}")
    def check(name, t, dtype, shape):
        _build.check_tensor("wave_cache", name, t, dtype, shape, dev)
    check("addr_lb", addr_lb, I32, (lanes, b))
    for name, t, dt in (("pc_b", pc_b, I32), ("owt_b", owt_b, I32),
                        ("slot_ok", slot_ok, BOOL),
                        ("tokens_b", tokens_b, BOOL), ("t0", t0, F32)):
        check(name, t, dt, (b,))
    for f, t in zip(CLF.ClassifierState._fields, clf_b0):
        check(f"clf_b0.{f}", t, F32 if f == "ratio" else I32, (b,))
    shapes = {"tags": (prm.sets, prm.ways), "rrip": (prm.sets, prm.ways),
              "meta_type": (prm.sets, prm.ways), "eaf": (prm.eaf_bits,),
              "eaf_gen": (), "eaf_ctr": (), "pc_hits": (prm.pc_entries,),
              "pc_acc": (prm.pc_entries,), "pc_req": (prm.pc_entries,)}
    for f in _STATE_FIELDS:
        check(f"st.{f}", getattr(st, f), I32, shapes[f])
    for f, t in zip(PolicyArrays._fields, pa):
        if t.dtype != F32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"wave_cache: pa.{f} must be a contiguous "
                             f"float32 tensor on {dev}")

    new = {f: getattr(st, f).clone() for f in _STATE_FIELDS}
    clf = clf_b0._replace(**{f: t.clone() for f, t in
                             zip(CLF.ClassifierState._fields, clf_b0)})
    shape = (lanes, b)
    recs = (torch.empty(shape, dtype=F32, device=dev),
            torch.empty(shape, dtype=I32, device=dev),
            *(torch.empty(shape, dtype=BOOL, device=dev) for _ in range(5)),
            torch.empty(shape, dtype=I32, device=dev),
            torch.empty(shape, dtype=BOOL, device=dev))
    WAVE_CACHE.launch(
        b, lanes, prm.sets, prm.ways, prm.eaf_bits, prm.pc_entries,
        prm.rrip_max, prm.eaf_capacity,
        # float32 roundings of the reference's Python doubles
        prm.lane_skew, float(prm.sampling_interval),
        float(prm.probe_interval), prm.mostly_hit_threshold,
        prm.mostly_miss_threshold, WT._EPS, 1.0 - WT._EPS,
        *(ptr(t) for t in (addr_lb, pc_b, owt_b, slot_ok, tokens_b, t0)),
        *(ptr(getattr(pa, f)) for f in (
            "bypass_sel", "ins_sel", "sched_medic", "rand_p", "label_sel",
            "reclass_interval", "probe_interval")),
        *(ptr(new[f]) for f in _STATE_FIELDS),
        *(ptr(getattr(clf, f)) for f in _CLF_ORDER),
        *(ptr(r) for r in recs), stream_of(addr_lb))
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
