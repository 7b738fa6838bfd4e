"""Plain PyTorch version of the flash attention kernel (a torch form of
``repro.kernels.flash_attention.ref``).

Layout: q [B, S, H, D], k/v [B, Skv, Hkv, D] with GQA group G = H // Hkv
(query head h reads KV head h // G). Computation in float32, output cast
to q's dtype.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None):
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, hkv, g, d).to(F32)
    logits = torch.einsum("bqkgd,bskd->bqkgs", qg, k.to(F32)) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((s, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask[None, :, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", w, v.to(F32))
    return o.reshape(b, s, h, d).to(q.dtype)
