"""Backend-gated MeDiC block-pool gather.

``medic_gather(pool, block_tbl)`` returns ``pool[block_tbl]`` page by page,
with zero pages for holes (``block_tbl < 0``); ``medic_gather_pools(pools,
block_tbl)`` does the same for several pools of one shape and dtype under
one table (the engine's offload reads K and V) and returns them stacked on
a leading pool axis. Backends:

  * ``"ref"``  — the plain PyTorch version (``ref.py``), on any device.
  * ``"cuda"`` — the hand-written Hopper kernel ``csrc/medic_gather.cu``:
    one launch per call whatever the number of pools, a byte copy, so
    bitwise equal to the plain version for every dtype. CUDA tensors
    only; raises otherwise.
  * ``"auto"`` — the kernel for CUDA tensors, the plain version for CPU
    tensors.

Table entries must index the pool (the kernel clamps larger ones to the
last page, as the reference's gather does).
"""
from __future__ import annotations

import array
import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import Kernel, stream_of
from repro_torch.kernels.medic_gather import ref as _ref

BACKENDS = _build.BACKENDS

#: most pools one launch takes (kMaxPools in the source)
MAX_POOLS = 8

MEDIC_GATHER = Kernel("medic_gather", [ctypes.c_void_p])


class _Layout(NamedTuple):
    """What a launch needs that depends on the shapes alone."""
    out_shape: tuple    # [n_pools, B, P, page, H, D]
    head: list          # n_pools, n, B * P, page bytes
    vec_pages: bool     # pages a whole number of 16-byte words


@functools.lru_cache(maxsize=64)
def _layout(got: tuple) -> _Layout:
    """The launch's layout from ``got``: (shape, dtype, device index,
    contiguous) of each pool, then of the table. Raises unless the pools
    are 1..MAX_POOLS contiguous [N, page, H, D] tensors of one shape and
    dtype and the table a contiguous int32 [B, P] tensor, all on one CUDA
    device (a raise is not cached)."""
    (shape, dtype, dev, _), tbl = got[0], got[-1]
    n_pools = len(got) - 1
    if dev < 0:
        raise ValueError("medic_gather_cuda needs CUDA tensors")
    if not 1 <= n_pools <= MAX_POOLS:
        raise ValueError(f"medic_gather: 1..{MAX_POOLS} pools, got {n_pools}")
    if len(shape) != 4 or len(tbl[0]) != 2 \
            or any(g != (shape, dtype, dev, True) for g in got[:-1]) \
            or tbl[1:] != (torch.int32, dev, True):
        raise ValueError(
            "medic_gather: pools must be contiguous [N, page, H, D] tensors "
            "of one shape and dtype and block_tbl a contiguous int32 [B, P] "
            "tensor, all on one CUDA device; got (shape, dtype, device, "
            f"contiguous) {[(tuple(g[0]),) + g[1:] for g in got]}")
    n, page, h, d = shape
    b, p = tbl[0]
    page_bytes = page * h * d * dtype.itemsize
    return _Layout(out_shape=(n_pools, b, p, page, h, d),
                   head=[n_pools, n, b * p, page_bytes],
                   vec_pages=page_bytes % 16 == 0)


def _launch(pools, block_tbl, stacked: bool):
    """One launch over ``pools``: [n_pools, B, P, page, H, D] if
    ``stacked``, else the one pool's [B, P, page, H, D] (the same bytes).
    Checks read tensor attributes only."""
    lay = _layout(tuple([(t.shape, t.dtype, t.get_device(), t.is_contiguous())
                         for t in (*pools, block_tbl)]))
    pool = pools[0]
    out = pool.new_empty(lay.out_shape if stacked else lay.out_shape[1:])
    src = [t.data_ptr() for t in pools]
    vec = lay.vec_pages and not any(x & 15 for x in src)
    args = array.array("q", lay.head + [vec, block_tbl.data_ptr(),
                                        out.data_ptr(), stream_of(pool)]
                       + src)
    MEDIC_GATHER.launch(args.buffer_info()[0])
    return out


def medic_gather_cuda(pool, block_tbl):
    """The Hopper kernel: [B, P, page, H, D] from one launch."""
    _build.refuse_grad("medic_gather", pool)
    return _launch((pool,), block_tbl, False)


def medic_gather_pools_cuda(pools, block_tbl) -> torch.Tensor:
    """The Hopper kernel over several pools: [n_pools, B, P, page, H, D]
    from one launch."""
    _build.refuse_grad("medic_gather", *pools)
    return _launch(pools, block_tbl, True)


def medic_gather(pool, block_tbl, *, backend: str = "auto"):
    """pool: [N, page, H, D]; block_tbl: i32[B, P] -> [B, P, page, H, D]."""
    if _build.resolve_backend("gather", backend, pool.device) == "ref":
        return _ref.medic_gather_ref(pool, block_tbl)
    return medic_gather_cuda(pool, block_tbl)


def medic_gather_pools(pools, block_tbl, *,
                       backend: str = "auto") -> torch.Tensor:
    """pools: [N, page, H, D] each, of one shape and dtype; block_tbl:
    i32[B, P] -> [n_pools, B, P, page, H, D], whose ``[i]`` equals
    ``medic_gather(pools[i], block_tbl)``."""
    if _build.resolve_backend("gather", backend, pools[0].device) == "ref":
        return torch.stack([_ref.medic_gather_ref(p, block_tbl)
                            for p in pools])
    return medic_gather_pools_cuda(pools, block_tbl)
