"""The dry run's "profiler" (the port of ``repro.launch.hlo_analysis``):
an op-stream counter over one eager step.

The reference compiles the step with XLA and reads the partitioned
program's text: dot FLOPs, a memory-traffic estimate and collective bytes,
rolled up through while loops whose bodies ``cost_analysis`` counts once.
Eager PyTorch has no compiled program; what the device runs is the
stream of ATen operations the step dispatches. ``OpCounter`` is a
``TorchDispatchMode`` over that stream (not ``FlopCounterMode``, whose
module hooks break a train step that runs ``autograd.grad`` inside
``functional_call``):

  * dot FLOPs, the reference's rule: 2 · output elements · contracted
    size, over ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``addbmm``,
    ``mv``, ``addmv`` and ``dot``;
  * memory traffic, the reference's rule: 2 × the output bytes of every
    operation that is neither a view nor an alias of its inputs; an
    in-place operation counts 2 × the bytes it writes (its other tensor
    inputs' bytes, at most the written tensor's); an allocation without
    data (``empty``) counts nothing. In eager torch every operation reads
    and writes device memory, so this is the traffic of the card's eager
    run, not a bound;
  * peak live bytes: every storage an operation allocates is followed by
    a weak reference until it is freed, so the peak of the bytes alive at
    once is the step's temporary memory (its arguments, made before the
    step, are not counted);
  * the model's kernels on meta tensors (``kernels._build.meta_launch``):
    one operation each, its products in the dot FLOPs and its inputs
    read and outputs written once in the traffic, as a custom call;
  * which of the ``watch``ed tensors the step reads (``read``): XLA
    drops the arguments a jitted step never reads from its program, and
    the reference's argument bytes with them. A storage is read when an
    operation takes it as an input, except an allocation that takes only
    its shape (``full_like``, ``zeros_like``, ...) and a ``copy_`` /
    ``fill_`` / ``zero_`` that overwrites all of it.

Only operations whose tensors lie on the counted device type are counted
(``"meta"`` in the dry run, ``"cuda"`` for the card's own step).

Of the reference's ``HloSummary`` the port keeps ``dot_flops``,
``mem_bytes``, ``coll_bytes``, ``coll_by_group``, ``coll_total`` and
``cross_pod_bytes()``. One process dispatches no collective, so the
collectives are added by the caller from the parameter plan
(``add_collective``; ``launch.dryrun``). Dropped: ``n_while`` and
``trip_counts`` (eager torch runs every loop iteration as its own
operations; nothing is counted once), and the dry run's ``loop_ratio``
and raw ``cost_analysis`` columns, which exist only to correct XLA's
loop counting.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import _build

aten = torch.ops.aten

#: the product operations whose FLOPs count (an op's first matrix operand
#: is at this argument index; its last dimension is the contracted one)
_PRODUCTS = {aten.mm: 0, aten.bmm: 0, aten.mv: 0, aten.addmm: 1,
             aten.baddbmm: 1, aten.addmv: 1, aten.addbmm: 1, aten.dot: 0,
             aten.vdot: 0}

#: allocations that write no data
_ALLOCS = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
           aten.new_empty_strided}

#: operations that read no value of their tensor inputs, only shapes
_SHAPE_ONLY = _ALLOCS | {aten.full_like, aten.zeros_like, aten.ones_like,
                         aten.new_full, aten.new_zeros, aten.new_ones,
                         aten.rand_like, aten.randn_like}

#: in-place operations that read nothing of the tensor they overwrite
_OVERWRITES = {aten.copy_, aten.fill_, aten.zero_}


def nbytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's own elements (not of its whole storage)."""
    return t.numel() * t.element_size()


def product_flops(func, args, out) -> int:
    """2 · output elements · contracted size of one product operation."""
    packet = func.overloadpacket
    a = args[_PRODUCTS[packet]]
    if packet in (aten.dot, aten.vdot):
        return 2 * a.numel()
    contracted = a.shape[-1]
    if packet is aten.addbmm:          # the batch is summed over too
        contracted *= a.shape[0]
    return 2 * out.numel() * contracted


@dataclasses.dataclass
class OpSummary:
    """The counted step (global figures: one process runs the whole
    batch)."""
    dot_flops: float = 0.0
    mem_bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_by_group: Dict[Tuple[str, int], float] = dataclasses.field(
        default_factory=dict)
    peak_bytes: int = 0
    n_ops: int = 0
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def coll_total(self) -> float:
        return sum(self.coll_bytes.values())

    def add_collective(self, kind: str, group_size: int,
                       nbytes_: float) -> None:
        """Count a collective of ``nbytes_`` wire bytes over a group of
        ``group_size`` devices."""
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0.0) + nbytes_
        key = (kind, group_size)
        self.coll_by_group[key] = self.coll_by_group.get(key, 0.0) + nbytes_

    def cross_pod_bytes(self, intra_pod_group_sizes=(1, 16, 256)) -> float:
        """Collective bytes on groups that span pods. On the 512-device
        (2, 16, 16) mesh: model-axis groups of 16 and data × model of 256
        are intra-pod; 2 (pod), 32 (pod × data) and 512 cross pods."""
        return sum(v for (k, gs), v in self.coll_by_group.items()
                   if gs not in intra_pod_group_sizes)


class OpCounter(TorchDispatchMode):
    """Counts the ATen operations dispatched on ``device`` (a device type)
    while active; ``summary`` has the totals, and ``read`` the indices
    (in ``watch``) of the tensors the step read. Use as a context
    manager."""

    def __init__(self, device: str = "meta", watch=()):
        super().__init__()
        self.device = torch.device(device).type
        self.summary = OpSummary()
        self._live: Dict[int, int] = {}    # id(storage) -> bytes
        self._live_bytes = 0
        # the watched storages, held so that their ids stay theirs
        self._watch = {}
        for i, t in enumerate(watch):
            st = t.untyped_storage()
            self._watch.setdefault(id(st), (st, []))[1].append(i)
        self.read: set = set()

    def _mark_read(self, t: torch.Tensor) -> None:
        hit = self._watch.get(id(t.untyped_storage()))
        if hit is not None:
            self.read.update(hit[1])

    # -- live storages -----------------------------------------------------

    def _freed(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self._live_bytes += st.nbytes()
        weakref.finalize(st, self._freed, key)
        self.summary.peak_bytes = max(self.summary.peak_bytes,
                                      self._live_bytes)

    # -- counting ----------------------------------------------------------

    def _on_device(self, tensors: List[torch.Tensor]) -> bool:
        return any(t.device.type == self.device for t in tensors)

    def _kernel(self, name, inputs, outputs, flops) -> None:
        ins = [t for t in tree_flatten(inputs)[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(outputs)[0]
                if isinstance(t, torch.Tensor)]
        if not self._on_device(ins + outs):
            return
        s = self.summary
        s.n_ops += 1
        for t in ins:
            self._mark_read(t)
        s.kernels[name] = s.kernels.get(name, 0) + 1
        s.dot_flops += flops
        s.mem_bytes += sum(nbytes(t) for t in ins + outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not self._on_device(ins + outs):
            return out
        s = self.summary
        s.n_ops += 1
        packet = func.overloadpacket
        if packet in _PRODUCTS:
            s.dot_flops += product_flops(func, args, out)
        written = []
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                written += [t for t in tree_flatten(v)[0]
                            if isinstance(t, torch.Tensor)]
        w_ids = {id(t) for t in written}
        if written:
            w_bytes = sum(nbytes(t) for t in written)
            other = sum(nbytes(t) for t in ins if id(t) not in w_ids)
            s.mem_bytes += 2 * (min(w_bytes, other) if other else w_bytes)
        if packet not in _SHAPE_ONLY:
            for t in ins:
                if id(t) in w_ids and packet in _OVERWRITES and \
                        nbytes(t) == t.untyped_storage().nbytes():
                    continue
                self._mark_read(t)
        in_storages = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            if t.device.type != self.device or \
                    id(t.untyped_storage()) in in_storages:
                continue                   # a view or alias of an input
            if not written and packet not in _ALLOCS:
                s.mem_bytes += 2 * nbytes(t)
            self._track(t)
        return out

    def __enter__(self):
        _build.META_SINKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.META_SINKS.remove(self._kernel)
        return super().__exit__(*exc)

