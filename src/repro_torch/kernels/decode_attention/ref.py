"""Plain PyTorch version of paged decode attention (a torch form of
``repro.kernels.decode_attention.ref``).

One new token per sequence attends over a paged KV pool through a block
table. Entries < 0 in the block table are holes (not resident) and are
fully masked; a row with no unmasked position gives zeros.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
NEG_INF = -1e30


def paged_decode_attention_ref(q, k_pool, v_pool, block_tbl, lengths):
    """q: [B, Hkv, G, D]; pools: [N, page, Hkv, D]; block_tbl: [B, P];
    lengths: [B]. Returns [B, Hkv, G, D]."""
    b, hkv, g, d = q.shape
    n, page, _, _ = k_pool.shape
    p = block_tbl.shape[1]
    scale = 1.0 / math.sqrt(d)

    tbl = torch.clamp_min(block_tbl, 0).long()
    k = k_pool[tbl]                                   # [B, P, page, Hkv, D]
    v = v_pool[tbl]
    k = torch.movedim(k, 3, 1).reshape(b, hkv, p * page, d)
    v = torch.movedim(v, 3, 1).reshape(b, hkv, p * page, d)
    pos = torch.arange(p * page, device=q.device)[None]
    resident = torch.repeat_interleave(block_tbl >= 0, page, dim=1)
    valid = (pos < lengths[:, None]) & resident       # [B, P*page]

    logits = torch.einsum("bhgd,bhsd->bhgs", q.to(F32), k.to(F32))
    logits = logits * scale
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(valid[:, None, None, :], w, 0.0)
    o = torch.einsum("bhgs,bhsd->bhgd", w, v.to(F32))
    return o.to(q.dtype)
