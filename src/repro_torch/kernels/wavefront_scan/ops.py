"""Backend-gated wavefront queue recovery (the timing pass of one wave).

``wave_queue_recovery`` computes one wave's bank / high-priority /
low-priority service times plus the advanced cross-wave queue carry.
Backends:

  * ``"ref"``  — the plain PyTorch version (``ref.py``), on any device.
  * ``"cuda"`` — the hand-written Hopper kernel ``csrc/wave_queue.cu``
    (one thread-block cluster of up to 8 blocks, ``plan_wave_queue``),
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

import array
import ctypes
import functools
import struct
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import Kernel, stream_of
from repro_torch.kernels.wavefront_scan import ref as _ref
from repro_torch.kernels.wavefront_scan.ref import QueueCarry

F32 = torch.float32
I32 = torch.int32
BOOL = torch.bool

BACKENDS = _build.BACKENDS

#: most banks or channels the kernel takes (QMAX in wave_queue.cu)
KERNEL_MAX_QUEUES = 8
#: the most blocks of the kernel's cluster, threads of a block and slots a
#: thread (kMaxBlocks, kMaxThreads, kMaxK in wave_queue.cu)
MAX_BLOCKS = 8
MAX_THREADS = 512
MAX_SLOTS_PER_THREAD = 16
#: slots a block aims at before the plan takes another block
BLOCK_SLOTS = 1024

WAVE_QUEUE = Kernel("wave_queue", [ctypes.c_void_p])


def resolve_backend(backend: str, device: torch.device) -> str:
    """``"auto"`` -> ``"cuda"`` for CUDA tensors, ``"ref"`` for CPU ones;
    ``"cuda"`` on a CPU tensor raises."""
    return _build.resolve_backend("scan", backend, device)


class WaveQueuePlan(NamedTuple):
    """How the kernel runs a wave of N slots: one cluster of ``blocks``
    blocks of ``threads``, each thread ``slots_per_thread`` consecutive
    slots, in ``passes`` passes of ``blocks * threads * slots_per_thread``
    slots (the scans carry their totals from one pass to the next), with
    ``smem_bytes`` of dynamic shared memory a block (four words a slot of
    a pass, rows of ``threads + 1``)."""
    blocks: int
    threads: int
    slots_per_thread: int
    passes: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def plan_wave_queue(n: int) -> WaveQueuePlan:
    """The kernel's plan for a wave of ``n`` slots, from ``n`` alone: one
    block per BLOCK_SLOTS slots, at most 8 (a portable cluster); then K =
    ceil(slots a block / 256) slots a thread, at most 16, on as few whole
    warps as cover them, at most 512. One pass up to 8 * 512 * 16 = 65,536
    slots, passes above. The launch takes it as it is."""
    if n < 0:
        raise ValueError(f"wave_queue: a wave of {n} slots")
    blocks = min(MAX_BLOCKS, max(1, -(-n // BLOCK_SLOTS)))
    per_block = max(1, -(-n // blocks))
    k = min(MAX_SLOTS_PER_THREAD, -(-per_block // 256))
    threads = min(MAX_THREADS, max(32, -(-(-(-per_block // k)) // 32) * 32))
    passes = max(1, -(-n // (blocks * threads * k)))
    return WaveQueuePlan(blocks, threads, k, passes, 16 * k * (threads + 1))


def _f32_bits(x: float) -> int:
    """The float32 rounding of ``x`` as its 32-bit pattern (an int)."""
    return struct.unpack("<i", struct.pack("<f", x))[0]


_SLOT_NAMES = ("t_s", "bank", "ch", "row", "use_l2", "go_dram", "byp", "hp")
_SLOT_TYPES = (F32, I32, I32, I32, BOOL, BOOL, BOOL, BOOL)


class _Layout(NamedTuple):
    """What a launch needs that depends on the shapes and constants."""
    plan: WaveQueuePlan
    head: list      # the argument array's first 12 entries
    expect: list    # (dtype, shape, device index, contiguous) of each input
    names: tuple    # the inputs' names, for errors
    words: int      # float32 words of the one output buffer
    split: list     # t_head, t0, eight carry fields, cur_row, row_hit
    offsets: list   # byte offsets of the 12 outputs in the buffer


@functools.lru_cache(maxsize=64)
def _layout(n: int, banks: int, channels: int, dev: int, l2_svc: float,
            l2_lat: float, occ_rowhit: float, occ_rowmiss: float,
            exact: bool) -> _Layout:
    """Checks the constants (a raise is not cached) and lays out the
    launch: the inputs it expects, the argument array's head and the one
    output buffer: float32 [t_head n, t0 n, the eight float carry fields],
    then cur_row int32 [channels], then row_hit bool [n] in whole words."""
    if not 1 <= banks <= KERNEL_MAX_QUEUES \
            or not 1 <= channels <= KERNEL_MAX_QUEUES:
        raise ValueError(f"wave_queue kernel takes 1..{KERNEL_MAX_QUEUES} "
                         f"banks and channels, got {banks}, {channels}")
    occs = (l2_svc, occ_rowhit, occ_rowmiss)
    if not all(float(o).is_integer() for o in occs) \
            or n * max(occs) >= 2 ** 24:
        raise ValueError("wave_queue kernel needs integer-valued occupancies "
                         "whose wave total stays below 2**24 (exact sums)")
    plan = plan_wave_queue(n)
    fields = QueueCarry._fields
    widths = [banks if f.startswith("bank") else channels for f in fields]
    expect = [(dt, torch.Size((n,)), dev, True) for dt in _SLOT_TYPES] + [
        (I32 if f == "cur_row" else F32, torch.Size((w,)), dev, True)
        for f, w in zip(fields, widths)]
    split = [n, n] + widths[:-1] + [channels, -(-n // 4)]
    offsets = [4 * sum(split[:i]) for i in range(len(split))]
    head = [n, banks, channels, int(exact), plan.blocks, plan.threads,
            plan.slots_per_thread, plan.smem_bytes,
            *(_f32_bits(x) for x in (l2_svc, l2_lat, occ_rowhit,
                                     occ_rowmiss))]
    return _Layout(plan, head, expect,
                   _SLOT_NAMES + tuple(f"carry.{f}" for f in fields),
                   sum(split), split, offsets)


def wave_queue_cuda(t_s, bank, use_l2, ch, row, go_dram, byp, hp,
                    carry: QueueCarry, *, banks: int, channels: int,
                    l2_svc: float, l2_lat: float, occ_rowhit: float,
                    occ_rowmiss: float, exact: bool):
    """The Hopper kernel: ``(t_head, t0, row_hit, new_carry)`` as
    ``wave_queue_recovery_ref`` returns them, from one launch. The outputs
    are views of one fresh buffer; the checks read tensor attributes
    against one cached layout."""
    if not t_s.is_cuda:
        raise ValueError("wave_queue_cuda needs CUDA tensors")
    lay = _layout(t_s.shape[0], banks, channels, t_s.get_device(),
                  l2_svc, l2_lat, occ_rowhit, occ_rowmiss, bool(exact))
    ins = (t_s, bank, ch, row, use_l2, go_dram, byp, hp, *carry)
    got = [(t.dtype, t.shape, t.get_device(), t.is_contiguous()) for t in ins]
    if got != lay.expect:
        i = next(i for i, (g, e) in enumerate(zip(got, lay.expect)) if g != e)
        raise ValueError(
            f"wave_queue: {lay.names[i]} must be a contiguous "
            f"{lay.expect[i][0]} tensor of shape {tuple(lay.expect[i][1])} "
            f"on {t_s.device}, got {ins[i].dtype} {tuple(ins[i].shape)} on "
            f"{ins[i].device}")
    buf = torch.empty(lay.words, dtype=F32, device=t_s.device)
    base = buf.data_ptr()
    args = array.array("q", lay.head + [t.data_ptr() for t in ins]
                       + [base + o for o in lay.offsets[:2]]
                       + [base + lay.offsets[-1]]
                       + [base + o for o in lay.offsets[2:-1]]
                       + [stream_of(t_s)])
    WAVE_QUEUE.launch(args.buffer_info()[0])
    parts = buf.split_with_sizes(lay.split)
    new = QueueCarry(*parts[2:10], cur_row=parts[10].view(I32))
    return parts[0], parts[1], parts[11].view(BOOL)[:lay.split[0]], new


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
