"""Backend-gated paged decode attention.

``paged_decode_attention(q, k_pool, v_pool, block_tbl, lengths)``: one
decode token per sequence attends over a paged KV pool through a block
table (holes, ``block_tbl < 0``, masked; positions ``>= lengths`` masked).
Backends:

  * ``"ref"``  — the plain PyTorch version (``ref.py``), on any device.
  * ``"cuda"`` — the hand-written Hopper kernel
    ``csrc/decode_attention.cu``: split-KV (flash-decoding), each
    sequence's positions split over ``plan_splits(...).n_split`` blocks,
    then one small kernel combines the splits; online softmax in float32.
    CUDA tensors only; raises otherwise.
  * ``"auto"`` — the kernel for CUDA tensors, the plain version for CPU
    tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import Kernel, ptr, stream_of
from repro_torch.kernels.decode_attention import ref as _ref

BACKENDS = _build.BACKENDS

#: limits of the kernel (csrc/decode_attention.cu: GMAX, DMAX_ALL)
KERNEL_MAX_G = 16
KERNEL_MAX_D = 256

#: positions per staged chunk, and most splits per (sequence, KV head)
#: (csrc/decode_attention.cu: TC, MAX_SPLITS)
CHUNK = 16
MAX_SPLITS = 256

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DECODE_ATTENTION = Kernel("decode_attention",
                          [_I] * 10 + [_F] + [_V] * 9)

DTYPES = (torch.float32, torch.bfloat16)


class SplitPlan(NamedTuple):
    """How the kernel splits each sequence's positions: split ``s`` owns
    ``[s * split_len, (s + 1) * split_len)``, cut at the sequence's
    length."""
    n_split: int
    split_len: int

    def ranges(self, length: int, capacity: int) -> List[Tuple[int, int]]:
        """Each split's live range ``[lo, hi)`` for a sequence of
        ``length`` positions in a table of ``capacity``; an empty split
        has ``lo == hi`` (it writes m = -1e30, l = 0)."""
        n = min(max(length, 0), capacity)
        starts = [min(s * self.split_len, n) for s in range(self.n_split)]
        return [(lo, min(lo + self.split_len, n)) for lo in starts]


def plan_splits(b: int, hkv: int, page: int, p: int, n_sm: int) -> SplitPlan:
    """The split of a [b, hkv] decode over a table of ``p`` pages of
    ``page`` positions, from the shape alone (the lengths stay on the
    card): enough splits that b * hkv * n_split blocks cover ``n_sm`` SMs
    about twice, none shorter than one staged chunk of ``CHUNK``
    positions, at most ``MAX_SPLITS``. At H100's 132 SMs: 128 splits of
    16 for the hybrid's (2, 1, ring 2048 as one page), 8 of 56 for
    Qwen3's serving path (4, 8, 28 pages of 16)."""
    cap = page * p
    n = min(max(1, 2 * n_sm // (b * hkv)), max(1, cap // CHUNK), MAX_SPLITS)
    split_len = -(-cap // n)
    return SplitPlan(-(-cap // split_len), split_len)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_plan(device, b: int, hkv: int, page: int, p: int) -> SplitPlan:
    """``plan_splits`` for the SMs of CUDA ``device``: the split the
    kernel takes there."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return plan_splits(b, hkv, page, p, _sm_count(index))


def paged_decode_attention_cuda(q, k_pool, v_pool, block_tbl, lengths):
    """The Hopper kernel: [B, Hkv, G, D] from one wrapper call (the split
    kernel, then the combine kernel)."""
    _build.refuse_grad("paged_decode_attention", q, k_pool, v_pool)
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
    plan = device_plan(dev, b, hkv, page, p)
    out = torch.empty_like(q)
    # float32 partials (m, l, acc) of every split
    parts = b * hkv * plan.n_split * g
    part_acc = torch.empty(parts * d, dtype=torch.float32, device=dev)
    part_ml = torch.empty(parts * 2, dtype=torch.float32, device=dev)
    DECODE_ATTENTION.launch(
        b, hkv, g, d, page, p, n, plan.n_split, plan.split_len,
        int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d), ptr(q),
        ptr(k_pool), ptr(v_pool), ptr(block_tbl), ptr(lengths),
        ptr(part_acc), ptr(part_ml), ptr(out), stream_of(q))
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tbl, lengths, *,
                           backend: str = "auto"):
    """q: [B, Hkv, G, D] one-token queries; pools [N, page, Hkv, D];
    block_tbl i32[B, P] (entries < 0 = non-resident, masked); lengths
    i32[B]. Returns [B, Hkv, G, D] in q's dtype.

    On meta tensors ``lengths`` holds no values: the launch counts every
    slot of the table (a filled cache's case), 4 · D products a slot for
    each query head."""
    if _build.on_meta(backend, q.device):
        b, hkv, g, d = q.shape
        slots = block_tbl.shape[1] * k_pool.shape[1]
        return _build.meta_launch(
            "paged_decode_attention", (q, k_pool, v_pool, block_tbl, lengths),
            torch.empty_like(q), 4 * b * hkv * g * d * slots)
    if _build.resolve_backend("decode_attention", backend, q.device) == "ref":
        return _ref.paged_decode_attention_ref(q, k_pool, v_pool, block_tbl,
                                               lengths)
    return paged_decode_attention_cuda(q, k_pool, v_pool, block_tbl, lengths)
