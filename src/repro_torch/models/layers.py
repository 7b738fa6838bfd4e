"""Shared layers of the model zoo, in torch (port of
``repro.models.layers``).

Layers are plain functions on tensors; parameters come in dict-like
containers (the ``nn.ParameterDict``s of ``blocks.DenseLayer``) under the
reference's names and shapes. Each parameter builder has a ``*_logical``
beside it that names the logical axes of every parameter (the
reference's ``Logical`` trees), and activations are tagged with
``shard_act`` at the reference's points (the identity on one device).

Attention:

* ``attention_full``    -- unblocked attention with explicit positions
  (the plain path and the oracle; ring buffers mask through ``kv_pos``).
* ``attention_train``   -- training attention, plain tensor code that
  autograd differentiates: ``attention_full`` up to the chunk threshold,
  else the chunked online softmax (``_block_attn`` / ``_combine``) with
  the reference's chunks and its SWA band. No kernel: the Hopper kernels
  have no backward.
* ``attention_prefill`` -- prefill from an empty cache (positions
  0..S-1), through the flash-attention kernel (``kernels/flash_attention``).
* ``attention_decode``  -- one-token attention against the ring cache with
  ``attention_full``'s masks (the reference's decode path).
* ``attention_decode_paged`` -- the same for full attention, through the
  paged decode kernel (``kernels/decode_attention``): the ring [B, W, Kv,
  D] is viewed as a page pool [B·P, page, Kv, D].
* ``attention_cross_decode`` -- one token against a fixed memory (an
  encoder's output, image embeddings), unmasked, through the paged decode
  kernel with the memory as one page a sequence. In prefill the memory
  goes through ``attention_prefill`` with ``causal=False``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.ops import paged_decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.sharding import Logical, shard_act

F32 = torch.float32
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# initializers / basics
# ---------------------------------------------------------------------------

# Initializers draw from an explicit ``torch.Generator`` on the device the
# parameters live on. ``gen=None`` asks for shapes only: the tensors are
# allocated on the ``meta`` device (no storage, no draws).

def _device(gen: Optional[torch.Generator]) -> torch.device:
    return torch.device("meta") if gen is None else gen.device


def dense_init(gen: Optional[torch.Generator], shape, in_axis_size, dtype):
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    scale = 1.0 / math.sqrt(max(1, in_axis_size))
    x = torch.randn(shape, generator=gen, dtype=F32, device=gen.device)
    return (x * scale).to(dtype)


def embed_init(gen: Optional[torch.Generator], shape, dtype):
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, dtype=F32, device=gen.device)
    return (x * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(F32))).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(F32) + bias.to(F32)).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as it lowers, ``x * (1 / (1 + exp(-x)))``, one
    operation at a time in x's dtype: in bfloat16 every step rounds, as in
    the reference (``F.silu`` rounds once and differs in ~40 % of bf16
    outputs)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` as it lowers, ``x * (0.5 * (1 +
    tanh(sqrt(2/pi) * (x + 0.044715 * x**3))))`` with ``x**3`` as ``x *
    (x * x)``, one operation at a time in x's dtype and with the constants
    rounded to it: in bfloat16 every step rounds, as in the reference
    (``F.gelu(approximate="tanh")`` rounds once and differs in ~40 % of
    bf16 outputs)."""
    c = x.new_full((), math.sqrt(2.0 / math.pi))
    k = x.new_full((), 0.044715)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * (x * x))))))


def activation(name: str):
    return {"silu": silu, "gelu": gelu, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split convention.

    x: [..., S, H, D]; positions: broadcastable to [..., S] (int).
    """
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    ang = positions[..., None].to(F32) * freqs        # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------

def _mask(q_pos, kv_pos, window: Optional[int], causal: bool):
    """q_pos: [..., Sq], kv_pos: [..., Sk] -> bool [..., Sq, Sk].

    kv_pos < 0 marks invalid (unfilled ring-buffer) slots.
    """
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    m = k >= 0
    if causal:
        m = m & (q >= k)
    if window is not None:
        m = m & ((q - k) < window)
    return m


def _softcap(logits, cap: Optional[float]):
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def _block_attn(q, k, v, qpos, kpos, *, window, causal, softcap, scale):
    """One flash block. q:[B,Q,Kv,G,D] k,v:[B,C,Kv,D] -> (s_max, p_sum, pv),
    the block's statistics in float32 for the online-softmax combine."""
    logits = torch.einsum("bqkgd,bckd->bqkgc", q.to(F32), k.to(F32)) * scale
    logits = _softcap(logits, softcap)
    msk = _mask(qpos, kpos, window, causal)[:, :, None, None, :]
    logits = torch.where(msk, logits, NEG_INF)
    s_max = torch.amax(logits, dim=-1)                    # [B,Q,Kv,G]
    p = torch.exp(logits - s_max[..., None])
    p = torch.where(msk, p, 0.0)
    p_sum = torch.sum(p, dim=-1)
    pv = torch.einsum("bqkgc,bckd->bqkgd", p, v.to(F32))
    return s_max, p_sum, pv


def _combine(m, l, acc, s_max, p_sum, pv):
    m_new = torch.maximum(m, s_max)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(s_max - m_new)
    l_new = l * alpha + p_sum * beta
    acc_new = acc * alpha[..., None] + pv * beta[..., None]
    return m_new, l_new, acc_new


def _group(q, num_kv):
    """[B,S,H,D] -> [B,S,Kv,G,D]"""
    b, s, h, d = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, d)


def _ungroup(o):
    b, s, kv, g, d = o.shape
    return o.reshape(b, s, kv * g, d)


def attention_full(q, k, v, q_pos, kv_pos, *, window=None, causal=True,
                   softcap=None) -> torch.Tensor:
    """Unblocked reference attention (small S / decode / oracle)."""
    num_kv = k.shape[2]
    qg = _group(q, num_kv)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqkgd,bskd->bqkgs", qg.to(F32), k.to(F32)) * scale
    logits = _softcap(logits, softcap)
    msk = _mask(q_pos, kv_pos, window, causal)[:, :, None, None, :]
    logits = torch.where(msk, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(msk, w, 0.0)  # rows with no valid kv -> 0
    o = torch.einsum("bqkgs,bskd->bqkgd", w, v.to(F32))
    return _ungroup(o).to(q.dtype)


def attention_train(q, k, v, q_pos, kv_pos, *, window=None, causal=True,
                    softcap=None, q_chunk=512, kv_chunk=512) -> torch.Tensor:
    """Training attention (the reference's AD-friendly flash attention).

    Up to ``max(q_chunk, 1024)`` queries, or when the chunks do not divide
    the lengths, it is ``attention_full``. Otherwise each query chunk runs
    an online softmax over key chunks: all of them, or, causal with a
    window, the band of ``window // kv_chunk + 2`` chunks ending at its
    diagonal. Band chunks before the first (the reference clips their
    index and masks them whole) leave the running statistics exactly as
    they are, so they are skipped."""
    b, s, h, d = q.shape
    num_kv = k.shape[2]
    if s <= max(q_chunk, 1024) or s % q_chunk or k.shape[1] % kv_chunk:
        return attention_full(q, k, v, q_pos, kv_pos, window=window,
                              causal=causal, softcap=softcap)
    sk = k.shape[1]
    nq, nk = s // q_chunk, sk // kv_chunk
    g = h // num_kv
    scale = 1.0 / math.sqrt(d)
    qg = _group(q, num_kv).reshape(b, nq, q_chunk, num_kv, g, d)
    kb = k.reshape(b, nk, kv_chunk, num_kv, d)
    vb = v.reshape(b, nk, kv_chunk, num_kv, d)
    qp = q_pos.expand(b, s).reshape(b, nq, q_chunk)
    kp = kv_pos.expand(b, sk).reshape(b, nk, kv_chunk)
    banded = window is not None and causal
    wblocks = min(nk, window // kv_chunk + 2) if banded else nk
    outs = []
    for i in range(nq):
        m = torch.full((b, q_chunk, num_kv, g), NEG_INF, dtype=F32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, q_chunk, num_kv, g, d), dtype=F32,
                          device=q.device)
        js = range(i - wblocks + 1, i + 1) if banded else range(nk)
        for j in js:
            if j < 0:
                continue
            jj = min(j, nk - 1)      # the reference's clip
            stats = _block_attn(qg[:, i], kb[:, jj], vb[:, jj], qp[:, i],
                                kp[:, jj], window=window, causal=causal,
                                softcap=softcap, scale=scale)
            m, l, acc = _combine(m, l, acc, *stats)
        outs.append((acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype))
    return _ungroup(torch.stack(outs, 1).reshape(b, s, num_kv, g, d))


def attention_prefill(q, k, v, *, window=None, causal=True,
                      backend: str = "auto") -> torch.Tensor:
    """Prefill attention from an empty cache: query and key positions are
    both 0..S-1, which is what the reference's ``attention_prefill``
    receives from a prefill. With ``causal=False`` and no window nothing
    is masked and k/v may hold Skv != S keys: the reference's
    ``attention_full`` with every position 0, as its encoder and cross-
    attention call it. Runs the flash-attention kernel (B5) on the card,
    its plain version on the CPU."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           backend=backend)


def attention_decode(q, k, v, q_pos, kv_pos, *, window=None, softcap=None):
    """Single-step decode attention. q: [B,1,H,D]; cache k/v: [B,S,Kv,D]."""
    return attention_full(q, k, v, q_pos, kv_pos, window=window, causal=True,
                          softcap=softcap)


def attention_decode_paged(q, k, v, block_tbl, lengths, *, page: int,
                           backend: str = "auto") -> torch.Tensor:
    """Single-step decode attention through the paged kernel (B4).

    q: [B,1,H,D]; ring cache k/v: [B,W,Kv,D] with W = P·page, viewed as a
    pool [B·P, page, Kv, D]; block_tbl: i32[B,P]; lengths: i32[B], the
    number of filled ring slots. For full attention (no window) this is
    ``attention_decode``: every filled slot holds a position at or before
    the query, so the ring's masks reduce to ``slot < lengths``.
    """
    b, w, kv, d = k.shape
    h = q.shape[2]
    pool_shape = (b * (w // page), page, kv, d)
    o = paged_decode_attention(q.reshape(b, kv, h // kv, d),
                               k.view(pool_shape), v.view(pool_shape),
                               block_tbl, lengths, backend=backend)
    return o.reshape(b, 1, h, d)


def attention_cross_decode(q, k, v, *, backend: str = "auto"
                           ) -> torch.Tensor:
    """One token a sequence against its whole memory: q [B, 1, H, D],
    k/v [B, Se, Kv, D], through the paged decode kernel (B4) with the
    memory viewed as one page a sequence (table ``arange(B)``, every
    length ``Se``), both built from k's own shape."""
    b, se = k.shape[:2]
    tbl = torch.arange(b, dtype=torch.int32, device=k.device)[:, None]
    lengths = torch.full((b,), se, dtype=torch.int32, device=k.device)
    return attention_decode_paged(q, k, v, tbl, lengths, page=se,
                                  backend=backend)


# ---------------------------------------------------------------------------
# attention block (projections + rope)
# ---------------------------------------------------------------------------

def attn_params(gen: Optional[torch.Generator], cfg, *, cross=False,
                dtype=None):
    """Parameters of one attention block, in the reference's layout; a
    cross-attention block (``cross``) has no q/k/v biases."""
    dtype = dtype or getattr(torch, cfg.dtype)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = _device(gen)
    p = {
        "wq": dense_init(gen, (d, h, hd), d, dtype),
        "wk": dense_init(gen, (d, kv, hd), d, dtype),
        "wv": dense_init(gen, (d, kv, hd), d, dtype),
        "wo": dense_init(gen, (h, hd, d), h * hd, dtype),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=F32, device=dev)
        p["k_norm"] = torch.zeros((hd,), dtype=F32, device=dev)
    return p


def attn_logical(cfg, *, cross=False):
    """The logical axes of ``attn_params``' leaves."""
    lg = {"wq": Logical("embed", "heads", "head_dim"),
          "wk": Logical("embed", "kv_heads", "head_dim"),
          "wv": Logical("embed", "kv_heads", "head_dim"),
          "wo": Logical("heads", "head_dim", "embed")}
    if cfg.qkv_bias and not cross:
        lg["bq"] = Logical("heads", "head_dim")
        lg["bk"] = Logical("kv_heads", "head_dim")
        lg["bv"] = Logical("kv_heads", "head_dim")
    if cfg.qk_norm:
        lg["q_norm"] = Logical("head_dim")
        lg["k_norm"] = Logical("head_dim")
    return lg


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matrix product."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(
        *x.shape[:-1], *w.shape[1:])


def attn_project_qkv(cfg, p, x, positions, *, use_rope=True):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = shard_act(q, "batch", None, "heads", None)
    k = shard_act(k, "batch", None, "kv_heads", None)
    v = shard_act(v, "batch", None, "kv_heads", None)
    return q, k, v


def attn_out(p, o):
    """einsum("bshk,hkd->bsd")."""
    wo = p["wo"]
    return o.reshape(*o.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_params(gen: Optional[torch.Generator], cfg, d_ff=None, *,
               gated=True, dtype=None):
    """The gated MLP (``w_gate``, ``w_up``, ``w_down``), or the ungated
    one of the encoder-decoder blocks (``w_up``, ``w_down`` and the biases
    ``b_up``, ``b_down``, which start at zero)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if gated:
        return {"w_gate": dense_init(gen, (d, f), d, dtype),
                "w_up": dense_init(gen, (d, f), d, dtype),
                "w_down": dense_init(gen, (f, d), f, dtype)}
    dev = _device(gen)
    return {"w_up": dense_init(gen, (d, f), d, dtype),
            "w_down": dense_init(gen, (f, d), f, dtype),
            "b_up": torch.zeros((f,), dtype=dtype, device=dev),
            "b_down": torch.zeros((d,), dtype=dtype, device=dev)}


def mlp_logical(*, gated=True):
    """The logical axes of ``mlp_params``' leaves."""
    if gated:
        return {"w_gate": Logical("embed", "mlp"),
                "w_up": Logical("embed", "mlp"),
                "w_down": Logical("mlp", "embed")}
    return {"w_up": Logical("embed", "mlp"), "w_down": Logical("mlp", "embed"),
            "b_up": Logical("mlp"), "b_down": Logical("embed")}


def mlp_apply(cfg, p, x):
    act = activation(cfg.act)
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = act(x @ p["w_up"] + p["b_up"])
    h = shard_act(h, "batch", None, "mlp")
    y = h @ p["w_down"]
    if "b_down" in p:
        y = y + p["b_down"]
    return y
