"""Backend-gated flash attention in the model layout.

``flash_attention(q, k, v, causal=, window=)`` takes q [B, S, H, D] and
k/v [B, Skv, Hkv, D] (query head h reads KV head h // (H // Hkv)) and
returns [B, S, H, D]. Backends:

  * ``"ref"``  — the plain PyTorch version (``ref.py``), on any device.
  * ``"cuda"`` — the hand-written Hopper kernel ``csrc/flash_attention.cu``
    (online softmax in float32, dead tiles skipped, any S; one launch, no
    transposes). CUDA tensors only; raises otherwise.
  * ``"auto"`` — the kernel for CUDA tensors, the plain version for CPU
    tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import Kernel, ptr, stream_of
from repro_torch.kernels.flash_attention import ref as _ref

BACKENDS = _build.BACKENDS

#: largest head dim of the kernel (csrc/flash_attention.cu: DMAX_ALL)
KERNEL_MAX_D = 256

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FLASH_ATTENTION = Kernel("flash_attention", [_I] * 9 + [_F] + [_V] * 5)

DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window=None):
    """The Hopper kernel: [B, S, H, D] from one launch."""
    _build.refuse_grad("flash_attention", q, k, v)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in {DTYPES}")
    b, s, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if h % hkv or not 1 <= d <= KERNEL_MAX_D:
        raise ValueError(f"flash_attention kernel takes H % Hkv == 0 and "
                         f"D <= {KERNEL_MAX_D}, got H={h}, Hkv={hkv}, D={d}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    for name, t, shape in (("q", q, (b, s, h, d)), ("k", k, (b, skv, hkv, d)),
                           ("v", v, (b, skv, hkv, d))):
        _build.check_tensor("flash_attention", name, t, q.dtype, shape, dev)
    out = torch.empty_like(q)
    FLASH_ATTENTION.launch(
        b, s, skv, h, hkv, d, int(causal), -1 if window is None else window,
        int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d), ptr(q), ptr(k),
        ptr(v), ptr(out), stream_of(q))
    return out


def live_pairs(s: int, skv: int, causal: bool, window=None) -> int:
    """(query, key) pairs the mask leaves live: key j <= query i when
    causal, and i - j < window with a window."""
    if not causal:
        return s * (skv if window is None else min(skv, window))
    w = s if window is None else min(window, s)
    # sum over i of min(i + 1, w)
    return w * (w + 1) // 2 + (s - w) * w


def flops(q, k, causal: bool = True, window=None) -> int:
    """Products of one call: q.k and p.v over the live pairs, 2 · D
    each, for every query head."""
    b, s, h, d = q.shape
    return 4 * b * h * d * live_pairs(s, k.shape[1], causal, window)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    backend: str = "auto"):
    """q [B, S, H, D], k/v [B, Skv, Hkv, D] -> [B, S, H, D] (q's dtype)."""
    if _build.on_meta(backend, q.device):
        return _build.meta_launch("flash_attention", (q, k, v),
                                  torch.empty_like(q),
                                  flops(q, k, causal, window))
    if _build.resolve_backend("flash_attention", backend, q.device) == "ref":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
