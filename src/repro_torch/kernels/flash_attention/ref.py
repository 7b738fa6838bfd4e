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


def flash_attention_tc_model(q, k, v, *, causal: bool = True, window=None,
                             block_k: int = 64):
    """The bf16 Hopper kernel's rounding in plain PyTorch, for the CPU
    tests: products of the bf16 inputs summed in float32, an online
    softmax in float32 over key tiles of ``block_k`` (csrc/
    flash_attention.cu: BK), P rounded to bf16 before P.V while l sums the
    float32 P, the output cast to q's dtype. Shapes as
    ``flash_attention_ref``."""
    b, s, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, hkv, g, d).to(F32)
    kf, vf = k.to(F32), v.to(F32)
    qpos = torch.arange(s, device=q.device)[:, None]
    m = torch.full((b, s, hkv, g), -math.inf, dtype=F32, device=q.device)
    lsum = torch.zeros_like(m)
    acc = torch.zeros((b, s, hkv, g, d), dtype=F32, device=q.device)
    for k0 in range(0, skv, block_k):
        kpos = torch.arange(k0, min(k0 + block_k, skv), device=q.device)[None]
        live = torch.ones((s, kpos.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            live &= qpos >= kpos
        if window is not None:
            live &= (qpos - kpos) < window
        live = live[None, :, None, None, :]
        x = torch.einsum("bqkgd,bskd->bqkgs", qg, kf[:, k0:k0 + block_k])
        x = torch.where(live, x * scale, -math.inf)
        m_new = torch.maximum(m, x.amax(-1))
        m_use = torch.where(torch.isinf(m_new), 0.0, m_new)
        pv = torch.exp(x - m_use[..., None])
        alpha = torch.exp(m - m_use)
        lsum = lsum * alpha + pv.sum(-1)
        pv16 = pv.to(torch.bfloat16).to(F32)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqkgs,bskd->bqkgd", pv16, vf[:, k0:k0 + block_k])
        m = m_new
    o = acc / torch.clamp_min(lsum, 1e-30)[..., None]
    return o.reshape(b, s, h, d).to(q.dtype)
