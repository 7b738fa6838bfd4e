"""Backend-gated paged decode attention.

``paged_decode_attention(q, k_pool, v_pool, block_tbl, lengths)``: one
decode token per sequence attends over a paged KV pool through a block
table (holes, ``block_tbl < 0``, masked; positions ``>= lengths`` masked).
Backends:

  * ``"ref"``  — the plain PyTorch version (``ref.py``), on any device.
  * ``"cuda"`` — the hand-written Hopper kernel
    ``csrc/decode_attention.cu`` (online softmax in float32, one launch).
    CUDA tensors only; raises otherwise.
  * ``"auto"`` — the kernel for CUDA tensors, the plain version for CPU
    tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import Kernel, ptr, stream_of
from repro_torch.kernels.decode_attention import ref as _ref

BACKENDS = _build.BACKENDS

#: limits of the kernel (csrc/decode_attention.cu: GMAX, DMAX_ALL)
KERNEL_MAX_G = 16
KERNEL_MAX_D = 256

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DECODE_ATTENTION = Kernel("decode_attention",
                          [_I] * 8 + [_F] + [_V] * 7)

DTYPES = (torch.float32, torch.bfloat16)


def paged_decode_attention_cuda(q, k_pool, v_pool, block_tbl, lengths):
    """The Hopper kernel: [B, Hkv, G, D] from one launch."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("paged_decode_attention_cuda needs CUDA tensors")
    if q.dtype not in DTYPES:
        raise ValueError(f"paged_decode_attention: dtype {q.dtype} not in "
                         f"{DTYPES}")
    b, hkv, g, d = q.shape
    n, page = k_pool.shape[:2]
    p = block_tbl.shape[1]
    if not (1 <= g <= KERNEL_MAX_G and 1 <= d <= KERNEL_MAX_D):
        raise ValueError(f"paged_decode_attention kernel takes G <= "
                         f"{KERNEL_MAX_G} and D <= {KERNEL_MAX_D}, got "
                         f"G={g}, D={d}")

    def check(name, t, dtype, shape):
        _build.check_tensor("paged_decode_attention", name, t, dtype, shape,
                            dev)
    check("q", q, q.dtype, (b, hkv, g, d))
    check("k_pool", k_pool, q.dtype, (n, page, hkv, d))
    check("v_pool", v_pool, q.dtype, (n, page, hkv, d))
    check("block_tbl", block_tbl, torch.int32, (b, p))
    check("lengths", lengths, torch.int32, (b,))
    out = torch.empty_like(q)
    DECODE_ATTENTION.launch(
        b, hkv, g, d, page, p, n, int(q.dtype == torch.bfloat16),
        1.0 / math.sqrt(d), ptr(q), ptr(k_pool), ptr(v_pool),
        ptr(block_tbl), ptr(lengths), ptr(out), stream_of(q))
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tbl, lengths, *,
                           backend: str = "auto"):
    """q: [B, Hkv, G, D] one-token queries; pools [N, page, Hkv, D];
    block_tbl i32[B, P] (entries < 0 = non-resident, masked); lengths
    i32[B]. Returns [B, Hkv, G, D] in q's dtype."""
    if _build.resolve_backend("decode_attention", backend, q.device) == "ref":
        return _ref.paged_decode_attention_ref(q, k_pool, v_pool, block_tbl,
                                               lengths)
    return paged_decode_attention_cuda(q, k_pool, v_pool, block_tbl, lengths)
