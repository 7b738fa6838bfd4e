"""Backend-gated RG-LRU recurrence.

``rg_lru(a, b, h0)`` returns h [B, S, W] with h_t = a_t * h_{t-1} + b_t
and h_{-1} = h0, in float32. Backends:

  * ``"ref"``  — the plain PyTorch version (``ref.py``), on any device.
  * ``"cuda"`` — the hand-written Hopper kernel ``csrc/rg_lru.cu`` (one
    thread per (batch, channel) walks time; any S and W). Bitwise equal
    to the plain version. CUDA tensors only; raises otherwise.
  * ``"auto"`` — the kernel for CUDA tensors, the plain version for CPU
    tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import Kernel, ptr, stream_of
from repro_torch.kernels.rg_lru import ref as _ref

BACKENDS = _build.BACKENDS

_V, _I = ctypes.c_void_p, ctypes.c_int
RG_LRU = Kernel("rg_lru", [_I] * 3 + [_V] * 5)

F32 = torch.float32


def rg_lru_cuda(a, b, h0):
    """The Hopper kernel: h [B, S, W] float32 from one launch."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError("rg_lru_cuda needs CUDA tensors")
    bsz, s, w = a.shape
    for name, t, shape in (("a", a, (bsz, s, w)), ("b", b, (bsz, s, w)),
                           ("h0", h0, (bsz, w))):
        _build.check_tensor("rg_lru", name, t, F32, shape, dev)
    out = torch.empty_like(a)
    RG_LRU.launch(bsz, s, w, ptr(a), ptr(b), ptr(h0), ptr(out),
                  stream_of(a))
    return out


def rg_lru(a, b, h0, *, backend: str = "auto"):
    """a, b: [B, S, W] float32; h0: [B, W] float32 -> h [B, S, W]."""
    if _build.resolve_backend("rg_lru", backend, a.device) == "ref":
        return _ref.rg_lru_ref(a, b, h0)
    return rg_lru_cuda(a, b, h0)
