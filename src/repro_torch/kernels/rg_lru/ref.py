"""Plain PyTorch version of the RG-LRU recurrence kernel (a torch form of
``repro.kernels.rg_lru.ref``): the sequential loop over time.

Each step is ``a_t * h + b_t``, one multiply and one add rounded to
float32 apiece; the kernel (``csrc/rg_lru.cu``, built without fused
multiply-adds) does the same operations, so the two agree bitwise.
"""
from __future__ import annotations

import torch


def rg_lru_ref(a, b, h0):
    """a, b: [B, S, W] float32; h0: [B, W]. Returns h: [B, S, W]."""
    h = h0.to(a.dtype)
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
