"""Block definitions, in torch (every block of ``repro.models.blocks``).

Block apply signature: (cfg, p, x, aux, cache) -> (x, cache, aux_loss),
the reference's; a block module's ``forward(x, aux, cache)`` returns the
same. ``aux_loss`` is the MoE layer's load-balancing loss (a float32
scalar tensor), and 0.0 for every other block (no launch to make a zero).

``aux`` carries the step's shared context:
  "mode" in {"train", "encode", "prefill", "decode"}, "backend" (the
  kernels' gate; serving only), "q_pos" [B,S] positions of the current
  tokens,
  decode only: "write_slot" [B] ring index of the new token, "kv_pos"
  [B,W] positions held in the ring (-1 empty), and the paged view of the
  ring — "page", "block_tbl" i32[B,P], "lengths" i32[B];
  the memories of cross-attention: "enc_out" [B,Se,D] (Whisper; the
  cache's copy in decode), "img" [B,Ti,D] (the VLM; prefill only).

Caches are per-layer slices of the stacked cache handed in by the stack
loop, and are updated IN PLACE (the reference returns new arrays; writing
into the slice saves a copy of the whole cache per step).

Training (mode "train", no cache; the encoder of ``Model.loss`` too) runs
the plain versions under autograd, never a kernel gate: the reference's
``attention_train`` for self-attention, ``attention_full`` for the
encoder's and for cross-attention, the plain RG-LRU loop, the plain
chunkwise mLSTM and the sLSTM loop. The Hopper kernels have no backward,
and their wrappers refuse an input that requires grad.

Each block's ``logical_fn(cfg)`` names the logical axes of its
parameters, and each cache builder has a ``*_cache_logical`` for its
leaves (the reference's ``Logical`` trees); the dense, MoE and local-
attention layers tag their residual stream with ``shard_act`` at the
reference's points.

Ported: the dense and MoE layers, RecurrentGemma's RG-LRU block and local
attention, xLSTM's mLSTM and sLSTM blocks, Whisper's encoder and decoder
layers and the VLM's gated cross-attention layer (its self-attention
layers are dense layers under the kind "self"). The serve path drops the
MoE layer's aux loss at the model, as the reference's ``prefill`` and
``decode`` do.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import recurrent as REC
from repro_torch.models import xlstm as XL
from repro_torch.models.stack import BlockDef
from repro_torch.sharding import Logical, shard_act

F32 = torch.float32


def _backend(aux) -> str:
    """The kernels' gate of a block: ``"ref"`` (the plain versions) in
    training, whatever the model's gate says; the model's otherwise."""
    return "ref" if aux["mode"] == "train" else aux.get("backend", "auto")


# ---------------------------------------------------------------------------
# shared attention plumbing
# ---------------------------------------------------------------------------

def _self_attention(cfg, p, x, aux, cache, *, window=None, use_rope=True,
                    causal=True):
    """Returns (attn_out, cache): ``attention_train`` in training (no
    cache), the kernels' routes in prefill and decode."""
    mode = aux["mode"]
    q, k, v = L.attn_project_qkv(cfg, p, x, aux["q_pos"], use_rope=use_rope)
    if mode == "train":
        o = L.attention_train(q, k, v, aux["q_pos"], aux["q_pos"],
                              window=window, causal=causal)
        return L.attn_out(p, o), None
    backend = aux.get("backend", "auto")
    if mode not in ("prefill", "decode") or cache is None:
        raise ValueError(f"self-attention in mode {mode!r} needs a cache "
                         "(prefill, decode) or mode 'train'")

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
    # the paged kernel. The ring holds the last W positions, q - W + 1 ..
    # q, in its filled slots, so every one is at or before the query; with
    # a window (dense SWA: W = min(seq_len, sliding_window); the hybrid's
    # local attention: W = min(seq_len, local_window)) W <= window, so q -
    # k <= W - 1 < window too. The reference's masks over the ring (k >=
    # 0, q >= k, q - k < window) therefore reduce to the filled prefix
    # ``lengths = min(len + 1, W)``, with or without a window
    # (Model.decode checks W <= window).
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


def _cross_attention(cfg, p, x, mem, aux, cache):
    """Cross-attention of x to a memory: no rope, no bias. In prefill (or
    without a cache) k, v come from ``mem`` and are written into the cache
    as ``xk``/``xv`` in the cache's dtype; in decode they are read from
    it. Nothing is masked (the reference's ``attention_full`` with all
    positions 0 and ``causal=False``): the flash kernel over the memory in
    prefill, the paged decode kernel over it as one page in decode, and
    ``attention_full`` itself in training."""
    q = L._proj(x, p["wq"])
    if aux["mode"] == "train":
        k, v = L._proj(mem, p["wk"]), L._proj(mem, p["wv"])
        qpos = torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device)
        kpos = torch.zeros(k.shape[:2], dtype=torch.int32, device=q.device)
        o = L.attention_full(q, k, v, qpos, kpos, causal=False)
        return L.attn_out(p, o), None
    backend = aux.get("backend", "auto")
    if aux["mode"] == "decode" and cache is not None:
        o = L.attention_cross_decode(q, cache["xk"], cache["xv"],
                                     backend=backend)
        return L.attn_out(p, o), cache
    k, v = L._proj(mem, p["wk"]), L._proj(mem, p["wv"])
    if cache is not None:
        cache["xk"].copy_(k)
        cache["xv"].copy_(v)
    o = L.attention_prefill(q, k, v, causal=False, backend=backend)
    return L.attn_out(p, o), cache


def _kv_cache_init(cfg, batch, w, dtype, device):
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, w, kv, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, w, kv, hd), dtype=dtype, device=device)}


def _kv_cache_logical(cfg=None):
    return {"k": Logical("batch", "kv_seq", "kv_heads", None),
            "v": Logical("batch", "kv_seq", "kv_heads", None)}


def _seq_sp(x):
    """The residual stream's constraint: batch rows, sequence-parallel."""
    return shard_act(x, "batch", "seq_sp", None)


# ---------------------------------------------------------------------------
# dense / moe transformer layer
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


def dense_layer_logical(cfg):
    return {"norm1": Logical("embed"), "attn": L.attn_logical(cfg),
            "norm2": Logical("embed"), "mlp": L.mlp_logical()}


def dense_layer_apply(cfg, p, x, aux, cache):
    x = _seq_sp(x)
    h = L.rms_norm(x, p.norm1, cfg.norm_eps)
    a, cache = _self_attention(cfg, p.attn, h, aux, cache,
                               window=cfg.sliding_window)
    x = x + _seq_sp(a)
    h = L.rms_norm(x, p.norm2, cfg.norm_eps)
    x = x + _seq_sp(L.mlp_apply(cfg, p.mlp, h))
    return x, cache, 0.0


def dense_layer_cache(cfg, batch, shape_cfg, device):
    w = shape_cfg.seq_len
    if cfg.sliding_window is not None:
        w = min(w, cfg.sliding_window)
    return _kv_cache_init(cfg, batch, w, getattr(torch, cfg.dtype), device)


def moe_layer_init(gen: Optional[torch.Generator], cfg):
    """A dense layer's parameters with the MoE FFN (``moe``) in place of
    the MLP."""
    ap = L.attn_params(gen, cfg)
    mp = MOE.moe_params(gen, cfg)
    return {"norm1": _norm_params(gen, cfg), "attn": ap,
            "norm2": _norm_params(gen, cfg), "moe": mp}


def moe_layer_logical(cfg):
    return {"norm1": Logical("embed"), "attn": L.attn_logical(cfg),
            "norm2": Logical("embed"), "moe": MOE.moe_logical()}


def moe_layer_apply(cfg, p, x, aux, cache):
    x = _seq_sp(x)
    h = L.rms_norm(x, p.norm1, cfg.norm_eps)
    a, cache = _self_attention(cfg, p.attn, h, aux, cache,
                               window=cfg.sliding_window)
    x = x + a
    h = L.rms_norm(x, p.norm2, cfg.norm_eps)
    y, aux_loss = MOE.moe_apply(cfg, p.moe, h)
    return _seq_sp(x + y), cache, aux_loss


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class _Block(nn.Module):
    """A block whose parameters are those of ``init_fn(None, cfg)``, with the
    reference's names and shapes: tensors become frozen parameters and
    sub-dicts ``nn.ParameterDict``s. Parameters start on the ``meta``
    device; ``Model.init_params`` or ``Model.load_params`` gives them
    storage."""

    init_fn = None    # (generator or None, cfg) -> parameter dict
    apply_fn = None   # (cfg, p, x, aux, cache) -> (x, cache, aux_loss)
    logical_fn = None  # cfg -> the parameters' Logical leaves, same keys

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        for name, t in type(self).init_fn(None, cfg).items():
            if isinstance(t, dict):
                t = nn.ParameterDict({k: _frozen(v) for k, v in t.items()})
            else:
                t = _frozen(t)
            setattr(self, name, t)

    def forward(self, x, aux, cache):
        return type(self).apply_fn(self.cfg, self, x, aux, cache)


class DenseLayer(_Block):
    """One dense decoder layer: pre-norm attention and gated MLP
    (``norm1``, ``attn.{wq,wk,wv,wo,q_norm,k_norm}``, ``norm2``,
    ``mlp.{w_gate,w_up,w_down}``)."""
    init_fn = staticmethod(dense_layer_init)
    apply_fn = staticmethod(dense_layer_apply)
    logical_fn = staticmethod(dense_layer_logical)


class MoELayer(_Block):
    """One MoE decoder layer: pre-norm attention and the MoE FFN
    (``norm1``, ``attn``, ``norm2``, ``moe.{router,w_gate,w_up,w_down}``)."""
    init_fn = staticmethod(moe_layer_init)
    apply_fn = staticmethod(moe_layer_apply)
    logical_fn = staticmethod(moe_layer_logical)


# ---------------------------------------------------------------------------
# RecurrentGemma blocks
# ---------------------------------------------------------------------------

def rec_block_init(gen: Optional[torch.Generator], cfg):
    rp = REC.rglru_params(gen, cfg)
    mp = L.mlp_params(gen, cfg)
    return {"norm1": _norm_params(gen, cfg), "rec": rp,
            "norm2": _norm_params(gen, cfg), "mlp": mp}


def rec_block_logical(cfg):
    return {"norm1": Logical("embed"), "rec": REC.rglru_logical(),
            "norm2": Logical("embed"), "mlp": L.mlp_logical()}


def rec_block_apply(cfg, p, x, aux, cache):
    h = L.rms_norm(x, p.norm1, cfg.norm_eps)
    y, cache = REC.rglru_apply(cfg, p.rec, h, cache, backend=_backend(aux))
    x = x + y
    h = L.rms_norm(x, p.norm2, cfg.norm_eps)
    x = x + L.mlp_apply(cfg, p.mlp, h)
    return x, cache, 0.0


def rec_block_cache(cfg, batch, shape_cfg, device):
    return REC.rglru_cache(cfg, batch, device)


def local_attn_apply(cfg, p, x, aux, cache):
    x = _seq_sp(x)
    h = L.rms_norm(x, p.norm1, cfg.norm_eps)
    a, cache = _self_attention(cfg, p.attn, h, aux, cache,
                               window=cfg.local_window)
    x = x + a
    h = L.rms_norm(x, p.norm2, cfg.norm_eps)
    x = x + L.mlp_apply(cfg, p.mlp, h)
    return x, cache, 0.0


def local_attn_cache(cfg, batch, shape_cfg, device):
    w = min(shape_cfg.seq_len, cfg.local_window)
    return _kv_cache_init(cfg, batch, w, getattr(torch, cfg.dtype), device)


class RecBlock(_Block):
    """RG-LRU block: ``norm1``, ``rec.{w_x,w_gate,conv_k,conv_b,w_r,b_r,
    w_i,b_i,lam,w_out}``, ``norm2``, ``mlp``."""
    init_fn = staticmethod(rec_block_init)
    apply_fn = staticmethod(rec_block_apply)
    logical_fn = staticmethod(rec_block_logical)


class LocalAttn(_Block):
    """The hybrid's local-attention layer: a dense layer whose attention
    keeps a window of ``cfg.local_window``."""
    init_fn = staticmethod(dense_layer_init)
    apply_fn = staticmethod(local_attn_apply)
    logical_fn = staticmethod(dense_layer_logical)


# ---------------------------------------------------------------------------
# xLSTM blocks
# ---------------------------------------------------------------------------

def mlstm_block_init(gen: Optional[torch.Generator], cfg):
    return {"norm": _norm_params(gen, cfg),
            "mlstm": XL.mlstm_params(gen, cfg)}


def mlstm_block_logical(cfg):
    return {"norm": Logical("embed"), "mlstm": XL.mlstm_logical()}


def mlstm_block_apply(cfg, p, x, aux, cache):
    h = L.rms_norm(x, p.norm, cfg.norm_eps)
    y, cache = XL.mlstm_apply(cfg, p.mlstm, h, cache, backend=_backend(aux))
    return x + y, cache, 0.0


def mlstm_block_cache(cfg, batch, shape_cfg, device):
    return XL.mlstm_cache(cfg, batch, device)


def slstm_block_init(gen: Optional[torch.Generator], cfg):
    p = XL.slstm_params(gen, cfg)
    mp = L.mlp_params(gen, cfg, d_ff=max(cfg.d_ff, 4 * cfg.d_model // 3))
    return {"norm1": _norm_params(gen, cfg), "slstm": p,
            "norm2": _norm_params(gen, cfg), "mlp": mp}


def slstm_block_logical(cfg):
    return {"norm1": Logical("embed"), "slstm": XL.slstm_logical(),
            "norm2": Logical("embed"), "mlp": L.mlp_logical()}


def slstm_block_apply(cfg, p, x, aux, cache):
    h = L.rms_norm(x, p.norm1, cfg.norm_eps)
    y, cache = XL.slstm_apply(cfg, p.slstm, h, cache)
    x = x + y
    h = L.rms_norm(x, p.norm2, cfg.norm_eps)
    x = x + L.mlp_apply(cfg, p.mlp, h)
    return x, cache, 0.0


def slstm_block_cache(cfg, batch, shape_cfg, device):
    return XL.slstm_cache(cfg, batch, device)


class MLSTMBlock(_Block):
    """mLSTM block: ``norm``, ``mlstm.{w_up,w_gate,w_q,w_k,w_v,w_if,b_if,
    w_o,skip}``."""
    init_fn = staticmethod(mlstm_block_init)
    apply_fn = staticmethod(mlstm_block_apply)
    logical_fn = staticmethod(mlstm_block_logical)


class SLSTMBlock(_Block):
    """sLSTM block: ``norm1``, ``slstm.{w_gates,b_gates,r_gates,w_out}``,
    ``norm2``, ``mlp``."""
    init_fn = staticmethod(slstm_block_init)
    apply_fn = staticmethod(slstm_block_apply)
    logical_fn = staticmethod(slstm_block_logical)


# ---------------------------------------------------------------------------
# Whisper blocks (encoder bidirectional; decoder self + cross)
# ---------------------------------------------------------------------------

def enc_layer_init(gen: Optional[torch.Generator], cfg):
    """Attention, then the ungated MLP."""
    ap = L.attn_params(gen, cfg)
    mp = L.mlp_params(gen, cfg, gated=False)
    return {"norm1": _norm_params(gen, cfg), "attn": ap,
            "norm2": _norm_params(gen, cfg), "mlp": mp}


def enc_layer_logical(cfg):
    return {"norm1": Logical("embed"), "attn": L.attn_logical(cfg),
            "norm2": Logical("embed"), "mlp": L.mlp_logical(gated=False)}


def enc_layer_apply(cfg, p, x, aux, cache):
    h = L.rms_norm(x, p.norm1, cfg.norm_eps)
    q, k, v = L.attn_project_qkv(cfg, p.attn, h, aux["q_pos"],
                                 use_rope=False)
    if aux["mode"] == "train":
        o = L.attention_full(q, k, v, aux["q_pos"], aux["q_pos"],
                             causal=False)
    else:
        o = L.attention_prefill(q, k, v, causal=False,
                                backend=aux.get("backend", "auto"))
    x = x + L.attn_out(p.attn, o)
    h = L.rms_norm(x, p.norm2, cfg.norm_eps)
    x = x + L.mlp_apply(cfg, p.mlp, h)
    return x, None, 0.0


def dec_layer_init(gen: Optional[torch.Generator], cfg):
    """Self-attention, cross-attention, then the ungated MLP."""
    ap = L.attn_params(gen, cfg)
    xp = L.attn_params(gen, cfg, cross=True)
    mp = L.mlp_params(gen, cfg, gated=False)
    return {"norm1": _norm_params(gen, cfg), "attn": ap,
            "norm2": _norm_params(gen, cfg), "xattn": xp,
            "norm3": _norm_params(gen, cfg), "mlp": mp}


def dec_layer_logical(cfg):
    return {"norm1": Logical("embed"), "attn": L.attn_logical(cfg),
            "norm2": Logical("embed"), "xattn": L.attn_logical(cfg, cross=True),
            "norm3": Logical("embed"), "mlp": L.mlp_logical(gated=False)}


def dec_layer_apply(cfg, p, x, aux, cache):
    self_cache = cross_cache = None
    if cache is not None:
        self_cache = {"k": cache["k"], "v": cache["v"]}
        cross_cache = {"xk": cache["xk"], "xv": cache["xv"]}
    h = L.rms_norm(x, p.norm1, cfg.norm_eps)
    a, _ = _self_attention(cfg, p.attn, h, aux, self_cache)
    x = x + a
    h = L.rms_norm(x, p.norm2, cfg.norm_eps)
    a, _ = _cross_attention(cfg, p.xattn, h, aux.get("enc_out"), aux,
                            cross_cache)
    x = x + a
    h = L.rms_norm(x, p.norm3, cfg.norm_eps)
    x = x + L.mlp_apply(cfg, p.mlp, h)
    return x, cache, 0.0


def dec_layer_cache(cfg, batch, shape_cfg, device):
    dtype = getattr(torch, cfg.dtype)
    c = _kv_cache_init(cfg, batch, shape_cfg.seq_len, dtype, device)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    for n in ("xk", "xv"):
        c[n] = torch.zeros((batch, cfg.encoder_seq_len, kv, hd), dtype=dtype,
                           device=device)
    return c


def dec_layer_cache_logical(cfg):
    lg = _kv_cache_logical()
    lg["xk"] = Logical("batch", "enc_seq", "kv_heads", None)
    lg["xv"] = Logical("batch", "enc_seq", "kv_heads", None)
    return lg


class EncLayer(_Block):
    """One Whisper encoder layer: pre-norm bidirectional attention (no
    rope, no cache) and the ungated MLP (``norm1``, ``attn``, ``norm2``,
    ``mlp.{w_up,w_down,b_up,b_down}``)."""
    init_fn = staticmethod(enc_layer_init)
    apply_fn = staticmethod(enc_layer_apply)
    logical_fn = staticmethod(enc_layer_logical)


class DecLayer(_Block):
    """One Whisper decoder layer: causal self-attention with rope, cross-
    attention to the encoder's output, the ungated MLP (``norm1``,
    ``attn``, ``norm2``, ``xattn.{wq,wk,wv,wo}``, ``norm3``, ``mlp``);
    its cache is ``{k, v, xk, xv}``."""
    init_fn = staticmethod(dec_layer_init)
    apply_fn = staticmethod(dec_layer_apply)
    logical_fn = staticmethod(dec_layer_logical)


# ---------------------------------------------------------------------------
# VLM cross block (Llama-3.2-Vision style gated cross-attention layer)
# ---------------------------------------------------------------------------

def vlm_cross_init(gen: Optional[torch.Generator], cfg):
    """Cross-attention, then the gated MLP; both gates 0-d float32, at
    zero (tanh(0) = 0: the layer starts as the identity)."""
    xp = L.attn_params(gen, cfg, cross=True)
    mp = L.mlp_params(gen, cfg)
    dev = L._device(gen)
    return {"norm1": _norm_params(gen, cfg), "xattn": xp,
            "gate_attn": torch.zeros((), dtype=F32, device=dev),
            "norm2": _norm_params(gen, cfg), "mlp": mp,
            "gate_mlp": torch.zeros((), dtype=F32, device=dev)}


def vlm_cross_logical(cfg):
    return {"norm1": Logical("embed"), "xattn": L.attn_logical(cfg, cross=True),
            "gate_attn": Logical(), "norm2": Logical("embed"),
            "mlp": L.mlp_logical(), "gate_mlp": Logical()}


def vlm_cross_apply(cfg, p, x, aux, cache):
    h = L.rms_norm(x, p.norm1, cfg.norm_eps)
    a, cache = _cross_attention(cfg, p.xattn, h, aux.get("img"), aux, cache)
    x = x + torch.tanh(p.gate_attn).to(x.dtype) * a
    h = L.rms_norm(x, p.norm2, cfg.norm_eps)
    x = x + torch.tanh(p.gate_mlp).to(x.dtype) * L.mlp_apply(cfg, p.mlp, h)
    return x, cache, 0.0


def vlm_cross_cache(cfg, batch, shape_cfg, device):
    dtype = getattr(torch, cfg.dtype)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {n: torch.zeros((batch, cfg.num_image_tokens, kv, hd),
                           dtype=dtype, device=device) for n in ("xk", "xv")}


def vlm_cross_cache_logical(cfg):
    return {n: Logical("batch", "kv_seq", "kv_heads", None)
            for n in ("xk", "xv")}


class VLMCross(_Block):
    """The VLM's gated cross-attention layer over the image embeddings
    (``norm1``, ``xattn.{wq,wk,wv,wo}``, ``gate_attn``, ``norm2``, ``mlp``,
    ``gate_mlp``); each branch is scaled by tanh of its gate. Its cache is
    ``{xk, xv}``."""
    init_fn = staticmethod(vlm_cross_init)
    apply_fn = staticmethod(vlm_cross_apply)
    logical_fn = staticmethod(vlm_cross_logical)


BLOCKS = {
    "layer": BlockDef("layer", DenseLayer, dense_layer_cache,
                      _kv_cache_logical),
    "moe_layer": BlockDef("moe_layer", MoELayer, dense_layer_cache,
                          _kv_cache_logical),
    "rec": BlockDef("rec", RecBlock, rec_block_cache,
                    lambda cfg: REC.rglru_cache_logical()),
    "attn": BlockDef("attn", LocalAttn, local_attn_cache, _kv_cache_logical),
    "mlstm": BlockDef("mlstm", MLSTMBlock, mlstm_block_cache,
                      lambda cfg: XL.mlstm_cache_logical()),
    "slstm": BlockDef("slstm", SLSTMBlock, slstm_block_cache,
                      lambda cfg: XL.slstm_cache_logical()),
    "enc": BlockDef("enc", EncLayer, None),
    "dec": BlockDef("dec", DecLayer, dec_layer_cache,
                    dec_layer_cache_logical),
    "self": BlockDef("self", DenseLayer, dense_layer_cache,
                     _kv_cache_logical),
    "cross": BlockDef("cross", VLMCross, vlm_cross_cache,
                      vlm_cross_cache_logical),
}
