"""Plain PyTorch versions of the mLSTM (torch forms of
``repro.models.xlstm.mlstm_recurrent_ref`` and ``mlstm_chunkwise``).

Layout: q, k [B, S, H, Dk]; v [B, S, H, Dv]; li (input-gate
preactivation) and lf (log-sigmoid forget gate) [B, S, H]; the state
(C [B, H, Dk, Dv], n [B, H, Dk], m [B, H]) float32, empty as (0, 0,
-1e30). Everything is computed in float32.

``mlstm_chunkwise_ref`` is the kernel's plain version: the reference's
chunk step, with chunks of ``CHUNK`` positions and a last chunk that may
be short (the reference falls back to the recurrent form unless S is a
multiple of its chunk). ``mlstm_recurrent_ref`` is the exact recurrent
form, which the model runs for one-token decode steps.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
NEG_INF = -1e30

#: the kernel's chunk length (csrc/mlstm.cu: L)
CHUNK = 64


def empty_state(b, h, dk, dv, device):
    return (torch.zeros((b, h, dk, dv), dtype=F32, device=device),
            torch.zeros((b, h, dk), dtype=F32, device=device),
            torch.full((b, h), NEG_INF, dtype=F32, device=device))


def mlstm_recurrent_ref(q, k, v, li, lf, state=None):
    """Exact recurrent mLSTM. Returns (h [B, S, H, Dv], (C, n, m))."""
    b, s, hh, dk = q.shape
    scale = 1.0 / math.sqrt(dk)
    if state is None:
        state = empty_state(b, hh, dk, v.shape[-1], q.device)
    c, n, m = (x.to(F32) for x in state)
    q, k, v, li, lf = (x.to(F32) for x in (q, k, v, li, lf))
    hs = []
    for t in range(s):
        qt, kt, vt, it, ft = q[:, t], k[:, t], v[:, t], li[:, t], lf[:, t]
        m_new = torch.maximum(ft + m, it)
        alpha = torch.exp(ft + m - m_new)
        beta = torch.exp(it - m_new)
        c = alpha[..., None, None] * c + beta[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = alpha[..., None] * n + beta[..., None] * kt
        num = torch.einsum("bhk,bhkv->bhv", qt, c) * scale
        den = torch.maximum(
            torch.abs(torch.einsum("bhk,bhk->bh", qt, n)) * scale,
            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, 1), (c, n, m)


def mlstm_chunkwise_ref(q, k, v, li, lf, state=None, chunk: int = CHUNK):
    """Stabilized chunkwise mLSTM from ``state``. Returns (h [B, S, H, Dv],
    (C, n, m))."""
    b, s, hh, dk = q.shape
    scale = 1.0 / math.sqrt(dk)
    if state is None:
        state = empty_state(b, hh, dk, v.shape[-1], q.device)
    c, n, m = (x.to(F32) for x in state)
    q, k, v, li, lf = (x.to(F32) for x in (q, k, v, li, lf))
    hs = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(c0 + chunk, s))
        qt, kt, vt, it, ft = q[:, sl], k[:, sl], v[:, sl], li[:, sl], lf[:, sl]
        lc = qt.shape[1]
        tri = torch.tril(torch.ones((lc, lc), dtype=torch.bool,
                                    device=q.device))
        bcum = torch.cumsum(ft, dim=1)                   # [B, L, H]
        btot = bcum[:, -1]                               # [B, H]
        dmat = bcum[:, :, None] - bcum[:, None, :] + it[:, None, :, :]
        dmat = torch.where(tri[None, :, :, None], dmat, NEG_INF)
        g = bcum + m[:, None, :]
        m_loc = torch.maximum(dmat.amax(dim=2), g)       # [B, L, H]
        w = torch.exp(dmat - m_loc[:, :, None, :])       # [B, L, L, H]
        qk = torch.einsum("bthk,bshk->btsh", qt, kt) * scale
        wqk = w * qk
        inter = torch.exp(g - m_loc)
        num = (torch.einsum("btsh,bshv->bthv", wqk, vt)
               + inter[..., None]
               * torch.einsum("bthk,bhkv->bthv", qt, c) * scale)
        den_dot = (wqk.sum(dim=2)
                   + inter * torch.einsum("bthk,bhk->bth", qt, n) * scale)
        den = torch.maximum(torch.abs(den_dot), torch.exp(-m_loc))
        hs.append(num / den[..., None])
        dend = btot[:, None, :] - bcum + it              # [B, L, H]
        m_new = torch.maximum(btot + m, dend.amax(dim=1))
        sc = torch.exp(dend - m_new[:, None, :])
        decay = torch.exp(btot + m - m_new)
        c = (decay[..., None, None] * c
             + torch.einsum("bshk,bshv->bhkv", sc[..., None] * kt, vt))
        n = decay[..., None] * n + torch.einsum("bsh,bshk->bhk", sc, kt)
        m = m_new
    return torch.cat(hs, 1), (c, n, m)


# ---------------------------------------------------------------------------
# the kernel's numerics
# ---------------------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = x.to(F32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(F32)


def tf32_split(x: torch.Tensor):
    """``(hi, lo)``: hi the TF32 rounding of ``x``, lo that of ``x - hi``;
    ``hi + lo`` keeps ~21 of float32's 24 bits, and a value with at most
    11 significant bits (bf16's 8) has ``lo == 0``."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tc_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the kernel's tensor-core products compute
    it: both operands split into TF32 hi/lo, three products (lo.hi, hi.lo,
    hi.hi; lo.lo dropped) summed in float32. Products of TF32 values are
    exact in float32."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) \
        + torch.einsum(eq, ah, bh)


def mlstm_chunkwise_tc_model(q, k, v, li, lf, state=None, chunk: int = CHUNK):
    """The chunkwise mLSTM with the kernel's product precision: the four
    products of a chunk (q.k^T, W.V, q.C, (k * sc)^T.V) as ``tc_einsum``,
    the rest in float32 as ``mlstm_chunkwise_ref``. Returns (h, (C, n,
    m))."""
    b, s, hh, dk = q.shape
    scale = 1.0 / math.sqrt(dk)
    if state is None:
        state = empty_state(b, hh, dk, v.shape[-1], q.device)
    c, n, m = (x.to(F32) for x in state)
    q, k, v, li, lf = (x.to(F32) for x in (q, k, v, li, lf))
    hs = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(c0 + chunk, s))
        qt, kt, vt, it, ft = q[:, sl], k[:, sl], v[:, sl], li[:, sl], lf[:, sl]
        lc = qt.shape[1]
        tri = torch.tril(torch.ones((lc, lc), dtype=torch.bool,
                                    device=q.device))
        bcum = torch.cumsum(ft, dim=1)
        btot = bcum[:, -1]
        dmat = bcum[:, :, None] - bcum[:, None, :] + it[:, None, :, :]
        dmat = torch.where(tri[None, :, :, None], dmat, NEG_INF)
        g = bcum + m[:, None, :]
        m_loc = torch.maximum(dmat.amax(dim=2), g)
        w = torch.exp(dmat - m_loc[:, :, None, :])
        qk = tc_einsum("bthk,bshk->btsh", qt, kt) * scale
        wqk = w * qk
        inter = torch.exp(g - m_loc)
        num = (tc_einsum("btsh,bshv->bthv", wqk, vt)
               + inter[..., None]
               * tc_einsum("bthk,bhkv->bthv", qt, c) * scale)
        den_dot = (wqk.sum(dim=2)
                   + inter * torch.einsum("bthk,bhk->bth", qt, n) * scale)
        den = torch.maximum(torch.abs(den_dot), torch.exp(-m_loc))
        hs.append(num / den[..., None])
        dend = btot[:, None, :] - bcum + it
        m_new = torch.maximum(btot + m, dend.amax(dim=1))
        sc = torch.exp(dend - m_new[:, None, :])
        decay = torch.exp(btot + m - m_new)
        c = (decay[..., None, None] * c
             + tc_einsum("bshk,bshv->bhkv", sc[..., None] * kt, vt))
        n = decay[..., None] * n + torch.einsum("bsh,bshk->bhk", sc, kt)
        m = m_new
    return torch.cat(hs, 1), (c, n, m)
