"""Block definitions, in torch (dense subset of ``repro.models.blocks``).

Block apply signature: (cfg, p, x, aux, cache) -> (x, cache)

``aux`` carries the step's shared context:
  "mode" in {"prefill", "decode"}, "backend" (the kernels' gate),
  "q_pos" [B,S] positions of the current tokens,
  decode only: "write_slot" [B] ring index of the new token, "kv_pos"
  [B,W] positions held in the ring (-1 empty), and the paged view of the
  ring — "page", "block_tbl" i32[B,P], "lengths" i32[B].

Caches are per-layer slices of the stacked cache handed in by the stack
loop, and are updated IN PLACE (the reference returns new arrays; writing
into the slice saves a copy of the whole cache per step).

Only the dense layer is ported; the other families' blocks (MoE,
RG-LRU, mLSTM/sLSTM, encoder-decoder, VLM cross-attention) wait for
ROADMAP A9 and B6/B7.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.stack import BlockDef

F32 = torch.float32


# ---------------------------------------------------------------------------
# shared attention plumbing
# ---------------------------------------------------------------------------

def _self_attention(cfg, p, x, aux, cache, *, window=None, use_rope=True,
                    causal=True):
    """Returns (attn_out, cache) for prefill and decode."""
    mode = aux["mode"]
    backend = aux.get("backend", "auto")
    if mode not in ("prefill", "decode") or cache is None:
        raise NotImplementedError(
            f"mode {mode!r} without a cache (training) is not ported to "
            "repro_torch yet (ROADMAP A9)")
    q, k, v = L.attn_project_qkv(cfg, p, x, aux["q_pos"], use_rope=use_rope)

    if mode == "prefill":
        o = L.attention_prefill(q, k, v, window=window, causal=causal,
                                backend=backend)
        w = cache["k"].shape[1]
        s = k.shape[1]
        if w >= s:
            cache["k"][:, :s] = k.to(cache["k"].dtype)
            cache["v"][:, :s] = v.to(cache["v"].dtype)
        else:
            # ring buffer: keep the last w tokens at slot = pos % w
            slots = aux["q_pos"][:, s - w:] % w                  # [B,w]
            _scatter_ring(cache["k"], k[:, s - w:], slots)
            _scatter_ring(cache["v"], v[:, s - w:], slots)
        return L.attn_out(p, o), cache

    # decode: write the new kv at write_slot, attend over the ring through
    # the paged kernel (full attention: Model.decode refuses windows)
    slot = aux["write_slot"]                                     # [B]
    _scatter_ring(cache["k"], k, slot[:, None])
    _scatter_ring(cache["v"], v, slot[:, None])
    o = L.attention_decode_paged(q, cache["k"], cache["v"], aux["block_tbl"],
                                 aux["lengths"], page=aux["page"],
                                 backend=backend)
    return L.attn_out(p, o), cache


def _scatter_ring(cache, kv_new, slots):
    """cache [B,W,kv,hd] <- kv_new [B,S,kv,hd] at ring slots [B,S], in
    place."""
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache[rows, slots.long()] = kv_new.to(cache.dtype)


def _kv_cache_init(cfg, batch, w, dtype, device):
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, w, kv, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, w, kv, hd), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# dense transformer layer
# ---------------------------------------------------------------------------

def _norm_params(gen, cfg):
    return torch.zeros((cfg.d_model,), dtype=F32, device=L._device(gen))


def dense_layer_init(gen: Optional[torch.Generator], cfg):
    """One layer's parameters drawn from ``gen`` (attention, then MLP;
    norms start at zero, so their scale is 1); ``gen=None`` gives meta
    tensors of the right shapes."""
    ap = L.attn_params(gen, cfg)
    mp = L.mlp_params(gen, cfg)
    return {"norm1": _norm_params(gen, cfg), "attn": ap,
            "norm2": _norm_params(gen, cfg), "mlp": mp}


def dense_layer_apply(cfg, p, x, aux, cache):
    h = L.rms_norm(x, p.norm1, cfg.norm_eps)
    a, cache = _self_attention(cfg, p.attn, h, aux, cache,
                               window=cfg.sliding_window)
    x = x + a
    h = L.rms_norm(x, p.norm2, cfg.norm_eps)
    x = x + L.mlp_apply(cfg, p.mlp, h)
    return x, cache


def dense_layer_cache(cfg, batch, shape_cfg, device):
    w = shape_cfg.seq_len
    if cfg.sliding_window is not None:
        w = min(w, cfg.sliding_window)
    return _kv_cache_init(cfg, batch, w, getattr(torch, cfg.dtype), device)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DenseLayer(nn.Module):
    """One dense decoder layer: pre-norm attention and gated MLP, with the
    reference's parameter names and shapes (``norm1``, ``attn.{wq,wk,wv,
    wo,q_norm,k_norm}``, ``norm2``, ``mlp.{w_gate,w_up,w_down}``).
    Parameters start on the ``meta`` device; ``Model.init_params`` or
    ``Model.load_params`` gives them storage."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        p = dense_layer_init(None, cfg)
        self.norm1 = _frozen(p["norm1"])
        self.attn = nn.ParameterDict({k: _frozen(t)
                                      for k, t in p["attn"].items()})
        self.norm2 = _frozen(p["norm2"])
        self.mlp = nn.ParameterDict({k: _frozen(t)
                                     for k, t in p["mlp"].items()})

    def forward(self, x, aux, cache):
        return dense_layer_apply(self.cfg, self, x, aux, cache)


BLOCKS = {"layer": BlockDef("layer", DenseLayer, dense_layer_cache)}
