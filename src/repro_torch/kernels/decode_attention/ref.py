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


def paged_decode_attention_split_model(q, k_pool, v_pool, block_tbl, lengths,
                                       n_split: int, split_len: int,
                                       chunk: int = 16):
    """The Hopper kernel's order of operations in plain PyTorch (float32),
    for the CPU tests: each sequence's positions cut into ``n_split``
    splits of ``split_len`` (ops.plan_splits), each split taken in chunks
    of ``chunk`` positions with an online softmax (running max m,
    normaliser l, accumulator acc; a split with nothing live keeps
    m = -1e30, l = 0), then the splits combined:
    M = max m_s, L = sum l_s e^(m_s - M),
    O = sum acc_s e^(m_s - M) / max(L, 1e-30). Shapes as
    ``paged_decode_attention_ref``."""
    b, hkv, g, d = q.shape
    page = k_pool.shape[1]
    p = block_tbl.shape[1]
    cap = p * page
    scale = 1.0 / math.sqrt(d)
    tbl = torch.clamp(block_tbl, 0, k_pool.shape[0] - 1).long()
    k = torch.movedim(k_pool[tbl], 3, 1).reshape(b, hkv, cap, d).to(F32)
    v = torch.movedim(v_pool[tbl], 3, 1).reshape(b, hkv, cap, d).to(F32)
    resident = torch.repeat_interleave(block_tbl >= 0, page, dim=1)
    # position of (split s, slot t): s * split_len + t, each split padded
    # to whole chunks; [n_split, span]
    n_chunk = -(-split_len // chunk)
    span = n_chunk * chunk
    slot = torch.arange(span, device=q.device)
    pos = torch.arange(n_split, device=q.device)[:, None] * split_len + slot
    at = torch.clamp(pos, max=cap - 1)
    valid = ((slot < split_len) & (pos < cap))[None] \
        & (pos[None] < lengths[:, None, None]) & resident[:, at]
    k, v = k[:, :, at], v[:, :, at]                     # [B, Hkv, S, span, D]
    qf = q.to(F32)
    m = torch.full((b, hkv, g, n_split), NEG_INF, dtype=F32, device=q.device)
    lsum = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, n_split, d), dtype=F32, device=q.device)
    for c in range(n_chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        live = valid[:, None, None, :, sl]              # [B, 1, 1, S, TC]
        x = torch.einsum("bhgd,bhstd->bhgst", qf, k[:, :, :, sl]) * scale
        x = torch.where(live, x, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1))
        pv = torch.where(live, torch.exp(x - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        lsum = lsum * alpha + pv.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgst,bhstd->bhgsd", pv,
                                                    v[:, :, :, sl])
        m = m_new
    big_m = m.amax(-1, keepdim=True)
    w = torch.exp(m - big_m)
    total = (lsum * w).sum(-1)
    o = (acc * w[..., None]).sum(-2) / torch.clamp_min(total, 1e-30)[..., None]
    return o.to(q.dtype)
