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


def rg_lru_ring_model(a, b, h0, steps: int, stages: int):
    """The kernel's walk (``csrc/rg_lru.cu``) replayed in order on the CPU:
    a and b are copied tile by tile (``steps`` time steps, the last tile
    short) into a ring of ``stages`` slots, tile k into slot k % stages;
    the first ``stages - 1`` tiles before the walk, then tile
    k + stages - 1 just before tile k is read. h is carried across tiles.
    Slots start as NaN, so a tile read from the wrong slot, or from one
    refilled too early in this order, shows in the result. Equal to
    ``rg_lru_ref`` bitwise. Being sequential, it says nothing of the
    ordering between the kernel's lanes."""
    bsz, s, w = a.shape
    ntiles = -(-s // steps)
    ring = torch.full((2, stages, bsz, steps, w), float("nan"),
                      dtype=a.dtype, device=a.device)

    def issue(k):
        if k < ntiles:
            t0 = k * steps
            n = min(steps, s - t0)
            ring[0, k % stages, :, :n] = a[:, t0:t0 + n]
            ring[1, k % stages, :, :n] = b[:, t0:t0 + n]

    for k in range(stages - 1):
        issue(k)
    h = h0.to(a.dtype)
    out = torch.empty_like(a)
    for k in range(ntiles):
        issue(k + stages - 1)
        slot_a, slot_b = ring[0, k % stages], ring[1, k % stages]
        for t in range(min(steps, s - k * steps)):
            h = slot_a[:, t] * h + slot_b[:, t]
            out[:, k * steps + t] = h
    return out
