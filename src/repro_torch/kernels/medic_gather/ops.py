"""Backend-gated MeDiC block-pool gather.

``medic_gather(pool, block_tbl)`` returns ``pool[block_tbl]`` page by page,
with zero pages for holes (``block_tbl < 0``). Backends:

  * ``"ref"``  — the plain PyTorch version (``ref.py``), on any device.
  * ``"cuda"`` — the hand-written Hopper kernel ``csrc/medic_gather.cu``:
    one launch per call, a byte copy, so bitwise equal to the plain
    version for every dtype. CUDA tensors only; raises otherwise.
  * ``"auto"`` — the kernel for CUDA tensors, the plain version for CPU
    tensors.

Table entries must index the pool (the kernel clamps larger ones to the
last page, as the reference's gather does).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import Kernel, ptr, stream_of
from repro_torch.kernels.medic_gather import ref as _ref

BACKENDS = _build.BACKENDS

_V, _I = ctypes.c_void_p, ctypes.c_int
MEDIC_GATHER = Kernel("medic_gather", [_I] * 4 + [_V] * 4)


def medic_gather_cuda(pool, block_tbl):
    """The Hopper kernel: [B, P, page, H, D] from one launch."""
    dev = pool.device
    if dev.type != "cuda":
        raise ValueError("medic_gather_cuda needs CUDA tensors")
    if pool.ndim != 4 or not pool.is_contiguous():
        raise ValueError(f"medic_gather: pool must be a contiguous [N, page, "
                         f"H, D] tensor, got {tuple(pool.shape)}")
    n, page, h, d = pool.shape
    if block_tbl.ndim != 2:
        raise ValueError("medic_gather: block_tbl must be [B, P]")
    b, p = block_tbl.shape
    _build.check_tensor("medic_gather", "block_tbl", block_tbl, torch.int32,
                        (b, p), dev)
    out = torch.empty((b, p, page, h, d), dtype=pool.dtype, device=dev)
    page_bytes = page * h * d * pool.element_size()
    vec = page_bytes % 16 == 0 and pool.data_ptr() % 16 == 0
    MEDIC_GATHER.launch(n, b * p, page_bytes, int(vec), ptr(pool),
                        ptr(block_tbl), ptr(out), stream_of(pool))
    return out


def medic_gather(pool, block_tbl, *, backend: str = "auto"):
    """pool: [N, page, H, D]; block_tbl: i32[B, P] -> [B, P, page, H, D]."""
    if _build.resolve_backend("gather", backend, pool.device) == "ref":
        return _ref.medic_gather_ref(pool, block_tbl)
    return medic_gather_cuda(pool, block_tbl)
