"""Backend-gated wavefront queue recovery (the timing pass of one wave).

``wave_queue_recovery`` computes one wave's bank / high-priority /
low-priority service times plus the advanced cross-wave queue carry.
Backends:

  * ``"ref"``  — the plain PyTorch version (``ref.py``), on any device.
  * ``"cuda"`` — the hand-written Hopper kernel ``csrc/wave_queue.cu``,
    which also fuses the carry advance (the reference's
    ``_carry_epilogue``): one launch returns ``(t_head, t0, row_hit,
    new_carry)``. It takes CUDA tensors only and raises otherwise.
  * ``"auto"`` — the kernel for CUDA tensors, the plain version for CPU
    tensors.

The kernel is bitwise equal to the plain version (integer-valued
occupancies make every prefix sum exact in any order); ``chip_smoke.py``
checks that on the card. The reference's ``fused`` and ``pallas``
backends are XLA:CPU and TPU forms and are not ported: the kernel takes
their place.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import Kernel, ptr, stream_of
from repro_torch.kernels.wavefront_scan import ref as _ref
from repro_torch.kernels.wavefront_scan.ref import QueueCarry

F32 = torch.float32
I32 = torch.int32

BACKENDS = _build.BACKENDS

#: most banks or channels the kernel takes (QMAX in wave_queue.cu)
KERNEL_MAX_QUEUES = 8

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
WAVE_QUEUE = Kernel("wave_queue",
                    [_I] * 4 + [_F] * 4 + [_V] * 8 + [_V] * 9 + [_V] * 3
                    + [_V] * 9 + [_V])


def resolve_backend(backend: str, device: torch.device) -> str:
    """``"auto"`` -> ``"cuda"`` for CUDA tensors, ``"ref"`` for CPU ones;
    ``"cuda"`` on a CPU tensor raises."""
    return _build.resolve_backend("scan", backend, device)


def wave_queue_cuda(t_s, bank, use_l2, ch, row, go_dram, byp, hp,
                    carry: QueueCarry, *, banks: int, channels: int,
                    l2_svc: float, l2_lat: float, occ_rowhit: float,
                    occ_rowmiss: float, exact: bool):
    """The Hopper kernel: ``(t_head, t0, row_hit, new_carry)`` as
    ``wave_queue_recovery_ref`` returns them, from one launch."""
    n = t_s.shape[0]
    dev = t_s.device
    if dev.type != "cuda":
        raise ValueError("wave_queue_cuda needs CUDA tensors")
    if not 1 <= banks <= KERNEL_MAX_QUEUES \
            or not 1 <= channels <= KERNEL_MAX_QUEUES:
        raise ValueError(f"wave_queue kernel takes 1..{KERNEL_MAX_QUEUES} "
                         f"banks and channels, got {banks}, {channels}")
    occs = (l2_svc, occ_rowhit, occ_rowmiss)
    if not all(float(o).is_integer() for o in occs) \
            or n * max(occs) >= 2 ** 24:
        raise ValueError("wave_queue kernel needs integer-valued occupancies "
                         "whose wave total stays below 2**24 (exact sums)")
    def check(name, t, dtype, shape):
        _build.check_tensor("wave_queue", name, t, dtype, shape, dev)
    for name, t, dt in (("t_s", t_s, F32), ("bank", bank, I32),
                        ("use_l2", use_l2, torch.bool), ("ch", ch, I32),
                        ("row", row, I32), ("go_dram", go_dram, torch.bool),
                        ("byp", byp, torch.bool), ("hp", hp, torch.bool)):
        check(name, t, dt, (n,))
    for f, t in zip(QueueCarry._fields, carry):
        q = banks if f.startswith("bank") else channels
        check(f"carry.{f}", t, I32 if f == "cur_row" else F32, (q,))

    t_head = torch.empty((n,), dtype=F32, device=dev)
    t0 = torch.empty((n,), dtype=F32, device=dev)
    row_hit = torch.empty((n,), dtype=torch.bool, device=dev)
    fl = torch.empty((2 * banks + 6 * channels,), dtype=F32, device=dev)
    new = QueueCarry(*torch.split(fl, [banks, banks] + [channels] * 6),
                     cur_row=torch.empty((channels,), dtype=I32, device=dev))
    WAVE_QUEUE.launch(
        n, banks, channels, int(bool(exact)), l2_svc, l2_lat, occ_rowhit,
        occ_rowmiss,
        *(ptr(t) for t in (t_s, bank, use_l2, ch, row, go_dram, byp, hp)),
        *(ptr(t) for t in carry), ptr(t_head), ptr(t0), ptr(row_hit),
        *(ptr(t) for t in new), stream_of(t_s))
    return t_head, t0, row_hit, new


def wave_queue_recovery(t_s, bank, use_l2, ch, row, go_dram, byp, hp,
                        carry: QueueCarry, *, banks: int, channels: int,
                        l2_svc: float, l2_lat: float, occ_rowhit: float,
                        occ_rowmiss: float, exact: bool,
                        backend: str = "auto"):
    """One wave's queue recovery under the selected backend.

    Slot arrays are [N] in warp-major chronological order. Returns
    ``(t_head, t0, row_hit, new_carry)`` — see ref.py for the contract.
    """
    kw = dict(banks=banks, channels=channels, l2_svc=l2_svc,
              l2_lat=l2_lat, occ_rowhit=occ_rowhit,
              occ_rowmiss=occ_rowmiss, exact=exact)
    if resolve_backend(backend, t_s.device) == "ref":
        return _ref.wave_queue_recovery_ref(
            t_s, bank, use_l2, ch, row, go_dram, byp, hp, carry, **kw)
    return wave_queue_cuda(t_s, bank, use_l2, ch, row, go_dram, byp, hp,
                           carry, **kw)
