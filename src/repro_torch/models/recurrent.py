"""RG-LRU recurrent block (RecurrentGemma / Griffin), in torch (port of
``repro.models.recurrent``).

Prefill runs the linear recurrence h_t = a_t * h_{t-1} + b_t through the
RG-LRU kernel (``kernels/rg_lru``: the Hopper kernel on the card, its
plain sequential loop on the CPU) where the reference takes an
associative scan; a one-token decode step is one multiply-add in plain
torch. Decode carries (h, conv-tap) state; all recurrence math is float32.
The cache is updated in place. Training (no cache: the zero-padded conv)
runs the scan's plain loop (``backend="ref"``) under autograd, since the
kernel has no backward.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rg_lru.ops import rg_lru
from repro_torch.models import layers as L
from repro_torch.sharding import Logical, shard_act

F32 = torch.float32
_C = 8.0  # RG-LRU decay sharpness constant


def rglru_params(gen: Optional[torch.Generator], cfg, dtype=None):
    """The reference's parameters and shapes; ``gen=None`` gives meta
    tensors."""
    dtype = dtype or getattr(torch, cfg.dtype)
    d, w, cw = cfg.d_model, cfg.lru_width, cfg.conv1d_width
    dev = L._device(gen)
    # Lambda init so the decay a = exp(-c*softplus(L)*r) lands in [0.9, 0.999]
    a0 = torch.linspace(0.9, 0.999, w, dtype=F32, device=dev)
    sp = -torch.log(a0) / _C                    # softplus(L) target
    lam = torch.log(torch.expm1(sp))            # inverse softplus
    return {
        "w_x": L.dense_init(gen, (d, w), d, dtype),
        "w_gate": L.dense_init(gen, (d, w), d, dtype),
        "conv_k": L.dense_init(gen, (cw, w), cw, F32),
        "conv_b": torch.zeros((w,), dtype=F32, device=dev),
        "w_r": L.dense_init(gen, (w, w), w, dtype),
        "b_r": torch.zeros((w,), dtype=F32, device=dev),
        "w_i": L.dense_init(gen, (w, w), w, dtype),
        "b_i": torch.zeros((w,), dtype=F32, device=dev),
        "lam": lam,
        "w_out": L.dense_init(gen, (w, d), w, dtype),
    }


def rglru_logical():
    """The logical axes of ``rglru_params``' leaves."""
    return {"w_x": Logical("embed", "lru"), "w_gate": Logical("embed", "lru"),
            "conv_k": Logical(None, "lru"), "conv_b": Logical("lru"),
            "w_r": Logical(None, "lru"), "b_r": Logical("lru"),
            "w_i": Logical(None, "lru"), "b_i": Logical("lru"),
            "lam": Logical("lru"), "w_out": Logical("lru", "embed")}


def _conv1d_causal(x, kernel, bias, state=None):
    """Depthwise causal conv. x: [B,S,W]; kernel: [CW,W].

    state: [B, CW-1, W] previous taps (decode) or None (zero pad). The taps
    are summed in the reference's order, ``kernel[cw-1-j]`` for j = 0...
    Returns (y, new_state).
    """
    cw = kernel.shape[0]
    xf = x.to(F32)
    if state is None:
        pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=F32,
                          device=x.device)
    else:
        pad = state.to(F32)
    full = torch.cat([pad, xf], dim=1)                  # [B, S+CW-1, W]
    y = torch.zeros_like(xf)
    for j in range(cw):
        y = y + full[:, j:j + x.shape[1]] * kernel[cw - 1 - j]
    new_state = full[:, -(cw - 1):] if cw > 1 else pad
    return (y + bias).to(x.dtype), new_state


def _gates(p, xc):
    r = torch.sigmoid((xc @ p["w_r"]).to(F32) + p["b_r"])
    i = torch.sigmoid((xc @ p["w_i"]).to(F32) + p["b_i"])
    log_a = -_C * F.softplus(p["lam"]) * r              # [B,S,W], <= 0
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (
        i * xc.to(F32))
    return a, gated_x


def rglru_scan(a, b, h0=None, *, backend: str = "auto"):
    """h_t = a_t * h_{t-1} + b_t through the RG-LRU kernel. a, b: [B,S,W]
    float32; h0: [B,W] or None (zeros)."""
    if h0 is None:
        h0 = torch.zeros((a.shape[0], a.shape[2]), dtype=F32, device=a.device)
    return rg_lru(a.contiguous(), b.contiguous(), h0.to(F32).contiguous(),
                  backend=backend)


def rglru_apply(cfg, p, x, cache=None, *, backend: str = "auto"):
    """x: [B,S,D]. cache: {"h": [B,W], "conv": [B,CW-1,W]} or None,
    updated in place. Returns (y, cache)."""
    xb = shard_act(x @ p["w_x"], "batch", None, "lru")
    gate = shard_act(x @ p["w_gate"], "batch", None, "lru")
    conv_state = cache["conv"] if cache is not None else None
    xc, new_conv = _conv1d_causal(xb, p["conv_k"], p["conv_b"], conv_state)
    a, b = _gates(p, xc)
    h0 = cache["h"] if cache is not None else None
    if x.shape[1] == 1 and cache is not None:  # decode fast path
        h = (a[:, 0] * h0.to(F32) + b[:, 0])[:, None]
    else:
        h = rglru_scan(a, b, h0, backend=backend)
    y = L.gelu(gate.to(F32)) * h
    out = y.to(x.dtype) @ p["w_out"]
    if cache is not None:
        cache["h"].copy_(h[:, -1])
        cache["conv"].copy_(new_conv)
    return out, cache


def rglru_cache(cfg, batch: int, device):
    w, cw = cfg.lru_width, cfg.conv1d_width
    return {"h": torch.zeros((batch, w), dtype=F32, device=device),
            "conv": torch.zeros((batch, cw - 1, w), dtype=F32,
                                device=device)}


def rglru_cache_logical():
    return {"h": Logical("batch", "lru"), "conv": Logical("batch", None, "lru")}
