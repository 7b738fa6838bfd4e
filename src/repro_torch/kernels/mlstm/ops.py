"""Backend-gated chunkwise mLSTM with its state.

``mlstm(q, k, v, li, lf, state)`` takes the model layout (q, k
[B, S, H, Dk], v [B, S, H, Dv], li and lf [B, S, H]) and the state it
starts from (C [B, H, Dk, Dv], n [B, H, Dk], m [B, H], or ``None`` for an
empty one), and returns (h [B, S, H, Dv] float32, (C, n, m) after the
last position). Backends:

  * ``"ref"``  — the plain PyTorch version (``ref.mlstm_chunkwise_ref``),
    on any device.
  * ``"cuda"`` — the hand-written Hopper kernel ``csrc/mlstm.cu`` (chunks
    of 64, any S; one call launches its two kernels, the chunk terms and
    the state recurrence, on the tensor cores). CUDA tensors only; raises
    otherwise.
  * ``"auto"`` — the kernel for CUDA tensors, the plain version for CPU
    tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import Kernel, ptr, stream_of
from repro_torch.kernels.mlstm import ref as _ref

BACKENDS = _build.BACKENDS

#: largest Dk of the kernel (csrc/mlstm.cu: DKMAX)
KERNEL_MAX_DK = 256

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MLSTM = Kernel("mlstm", [_I] * 6 + [_F] + [_V] * 14)

F32 = torch.float32
DTYPES = (torch.float32, torch.bfloat16)


def scratch_floats(b: int, s: int, h: int) -> int:
    """float32 elements of the kernel's scratch: per (batch, head, chunk)
    the weights [64, 64], four rows of 64 (exp(g - m_loc), the weights' row
    sums, exp(-m_loc), sc) and the decay (csrc/mlstm.cu: mlstm_launch)."""
    chunk = _ref.CHUNK
    return b * h * -(-s // chunk) * (chunk * chunk + 4 * chunk + 1)


def mlstm_cuda(q, k, v, li, lf, state=None):
    """The Hopper kernel: (h, (C, n, m)) from one launch call. The outputs
    and the scratch are views of one allocation."""
    _build.refuse_grad("mlstm", q, k, v, li, lf,
                       *(state or ()))
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("mlstm_cuda needs CUDA tensors")
    if q.dtype not in DTYPES:
        raise ValueError(f"mlstm: dtype {q.dtype} not in {DTYPES}")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if not 1 <= dk <= KERNEL_MAX_DK:
        raise ValueError(f"mlstm kernel takes Dk <= {KERNEL_MAX_DK}, got "
                         f"{dk}")
    if state is None:
        state = _ref.empty_state(b, h, dk, dv, dev)
    c0, n0, m0 = state

    def check(name, t, dtype, shape):
        _build.check_tensor("mlstm", name, t, dtype, shape, dev)
    check("q", q, q.dtype, (b, s, h, dk))
    check("k", k, q.dtype, (b, s, h, dk))
    check("v", v, q.dtype, (b, s, h, dv))
    check("li", li, F32, (b, s, h))
    check("lf", lf, F32, (b, s, h))
    check("C", c0, F32, (b, h, dk, dv))
    check("n", n0, F32, (b, h, dk))
    check("m", m0, F32, (b, h))
    # the scratch first: its float4 loads want a 16-byte start
    sizes = [scratch_floats(b, s, h), b * s * h * dv, c0.numel(), n0.numel(),
             m0.numel()]
    scratch, out, c1, n1, m1 = torch.empty(
        sum(sizes), dtype=F32, device=dev).split_with_sizes(sizes)
    out, c1, n1, m1 = (x.view(shape) for x, shape in (
        (out, (b, s, h, dv)), (c1, c0.shape), (n1, n0.shape), (m1, m0.shape)))
    MLSTM.launch(b, s, h, dk, dv, int(q.dtype == torch.bfloat16),
                 1.0 / math.sqrt(dk), ptr(q), ptr(k), ptr(v), ptr(li),
                 ptr(lf), ptr(c0), ptr(n0), ptr(m0), ptr(out), ptr(c1),
                 ptr(n1), ptr(m1), ptr(scratch), stream_of(q))
    return out, (c1, n1, m1)


def flops(b: int, s: int, h: int, dk: int, dv: int,
          chunk: int = _ref.CHUNK) -> int:
    """Products of one call, chunk by chunk of L positions: q.k (L·L·Dk),
    W.v (L·L·Dv), q.C (L·Dk·Dv), q.n (L·Dk), k^T.v into C (L·Dk·Dv) and
    the sum into n (L·Dk), 2 each, for every head."""
    total = 0
    for c0 in range(0, s, chunk):
        n = min(chunk, s - c0)
        total += n * n * (dk + dv) + 2 * n * dk * dv + 2 * n * dk
    return 2 * b * h * total


def mlstm(q, k, v, li, lf, state=None, *, backend: str = "auto"):
    """Chunkwise mLSTM from ``state`` (``None``: empty). Returns
    (h [B, S, H, Dv] float32, (C, n, m))."""
    if _build.on_meta(backend, q.device):
        b, s, h, dk = q.shape
        dv = v.shape[-1]
        st = _ref.empty_state(b, h, dk, dv, q.device) if state is None \
            else state
        out = (torch.empty((b, s, h, dv), dtype=F32, device=q.device),
               tuple(torch.empty_like(x, dtype=F32) for x in st))
        return _build.meta_launch("mlstm", (q, k, v, li, lf) + tuple(st),
                                  out, flops(b, s, h, dk, dv))
    if _build.resolve_backend("mlstm", backend, q.device) == "ref":
        return _ref.mlstm_chunkwise_ref(q, k, v, li, lf, state)
    return mlstm_cuda(q, k, v, li, lf, state)
