"""Backend-gated RG-LRU recurrence.

``rg_lru(a, b, h0)`` returns h [B, S, W] with h_t = a_t * h_{t-1} + b_t
and h_{-1} = h0, in float32. Backends:

  * ``"ref"``  — the plain PyTorch version (``ref.py``), on any device.
  * ``"cuda"`` — the hand-written Hopper kernel ``csrc/rg_lru.cu``: a block
    of one warp owns ``CHANNELS`` consecutive channels of one batch row and
    walks all of S. a and b stream through a ring of ``STAGES`` shared-
    memory tiles of ``STEPS`` time steps, ``STAGES - 1`` tiles of copies in
    flight while the warp carries h in registers through the current one;
    each h_t goes out with a streaming store. ``plan_rg_lru`` states the
    plan on the host and picks the copy instance: 16-byte copies where
    W % 4 == 0 and a and b are 16-byte aligned, else 4-byte copies (any W,
    any alignment); neither stands in for the other when a build or
    launch fails. One launch a call, any S and W. Bitwise equal to the
    plain version. CUDA tensors only; raises otherwise, and on a plan the
    kernel does not take.
  * ``"auto"`` — the kernel for CUDA tensors, the plain version for CPU
    tensors.

``ref.rg_lru_ring_model`` walks the kernel's tiles on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import Kernel, ptr, stream_of
from repro_torch.kernels.rg_lru import ref as _ref

BACKENDS = _build.BACKENDS

_V, _I = ctypes.c_void_p, ctypes.c_int
RG_LRU = Kernel("rg_lru", [_I] * 7 + [_V] * 5)

F32 = torch.float32

#: the tiles ``csrc/rg_lru.cu`` is built with (kC, kT, kStages), which its
#: C entry requires of a plan
CHANNELS, STEPS, STAGES = 32, 32, 4
MAX_B = 65535


class RgLruPlan(NamedTuple):
    """One launch: ``vec`` floats a copy (4: 16 bytes, 1: 4 bytes),
    ``channels`` a block, a ring of ``stages`` tiles of ``steps`` time steps
    for a and for b in ``smem_bytes`` of shared memory, ``blocks`` blocks
    of one warp."""
    vec: int
    channels: int
    steps: int
    stages: int
    smem_bytes: int
    blocks: int


@functools.lru_cache(maxsize=64)
def plan_rg_lru(b: int, s: int, w: int, aligned: bool, *,
                vec: Optional[int] = None) -> RgLruPlan:
    """The kernel's plan for a, b [b, s, w] whose pointers are 16-byte
    ``aligned`` or not: the 16-byte copy instance where ``w % 4 == 0`` and
    ``aligned``, else the 4-byte one. ``vec`` asks for an instance (4
    raises where it does not apply; 1 always does). Raises outside the
    kernel's bounds."""
    if not (1 <= b <= MAX_B and s >= 1 and w >= 1):
        raise ValueError(f"rg_lru kernel takes 1 <= B <= {MAX_B}, S >= 1, "
                         f"W >= 1; got B={b} S={s} W={w}")
    fits16 = w % 4 == 0 and aligned
    if vec is None:
        vec = 4 if fits16 else 1
    elif vec not in (1, 4) or (vec == 4 and not fits16):
        raise ValueError(f"rg_lru: the {4 * vec}-byte copy instance does not "
                         f"take W={w} with aligned={aligned}")
    return RgLruPlan(vec, CHANNELS, STEPS, STAGES,
                     2 * STAGES * STEPS * CHANNELS * 4,
                     -(-w // CHANNELS) * b)


def aligned16(*tensors) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def rg_lru_cuda(a, b, h0, *, plan: Optional[RgLruPlan] = None):
    """The Hopper kernel: h [B, S, W] float32 from one launch, under
    ``plan`` (``plan_rg_lru``'s for these tensors by default)."""
    _build.refuse_grad("rg_lru", a, b, h0)
    dev = a.device
    if dev.type != "cuda":
        raise ValueError("rg_lru_cuda needs CUDA tensors")
    bsz, s, w = a.shape
    for name, t, shape in (("a", a, (bsz, s, w)), ("b", b, (bsz, s, w)),
                           ("h0", h0, (bsz, w))):
        _build.check_tensor("rg_lru", name, t, F32, shape, dev)
    if plan is None:
        plan = plan_rg_lru(bsz, s, w, aligned16(a, b))
    out = torch.empty_like(a)
    RG_LRU.launch(bsz, s, w, plan.vec, plan.channels, plan.steps,
                  plan.stages, ptr(a), ptr(b), ptr(h0), ptr(out),
                  stream_of(a))
    return out


def rg_lru(a, b, h0, *, backend: str = "auto"):
    """a, b: [B, S, W] float32; h0: [B, W] float32 -> h [B, S, W]."""
    if _build.on_meta(backend, a.device):     # a multiply-add: no products
        return _build.meta_launch("rg_lru", (a, b, h0), torch.empty_like(a),
                                  0)
    if _build.resolve_backend("rg_lru", backend, a.device) == "ref":
        return _ref.rg_lru_ref(a, b, h0)
    return rg_lru_cuda(a, b, h0)
