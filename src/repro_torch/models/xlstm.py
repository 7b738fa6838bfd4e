"""xLSTM blocks, in torch (port of ``repro.models.xlstm``): the
chunkwise mLSTM and the sequential sLSTM.

mLSTM (matrix-memory LSTM): prefill runs the stabilized chunkwise form
with its state through the mLSTM kernel (``kernels/mlstm``: the Hopper
kernel on the card, its plain chunkwise version on the CPU); a one-token
decode step runs the exact recurrent form in plain torch, as the
reference does.

sLSTM has hidden-to-gate recurrence, so it is inherently sequential: a
Python loop over time with exponential-gating stabilizer state. It has no
Pallas kernel in the reference; each step is ~20 small torch operations.

Caches are updated in place. Training (no cache) runs the plain
chunkwise mLSTM (``backend="ref"``) and the sLSTM loop under autograd.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm.ops import mlstm
from repro_torch.kernels.mlstm.ref import NEG_INF, mlstm_recurrent_ref
from repro_torch.models import layers as L
from repro_torch.sharding import Logical, shard_act

F32 = torch.float32


def _logsig(x):
    return -F.softplus(-x)


# ===========================================================================
# mLSTM
# ===========================================================================

def mlstm_params(gen: Optional[torch.Generator], cfg, dtype=None):
    """up-proj x2, qkv heads, per-head scalar i/f gates, a learnable skip,
    down-proj (the reference's parameters and shapes)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    d, h, dqk = cfg.d_model, cfg.num_heads, cfg.head_dim
    dv = 2 * d // h               # value head dim (up-projection factor 2)
    inner = 2 * d
    dev = L._device(gen)
    return {
        "w_up": L.dense_init(gen, (d, inner), d, dtype),
        "w_gate": L.dense_init(gen, (d, inner), d, dtype),
        "w_q": L.dense_init(gen, (inner, h, dqk), inner, dtype),
        "w_k": L.dense_init(gen, (inner, h, dqk), inner, dtype),
        "w_v": L.dense_init(gen, (inner, h, dv), inner, dtype),
        "w_if": L.dense_init(gen, (inner, h, 2), inner, F32),
        "b_if": torch.cat([torch.zeros((h, 1), dtype=F32, device=dev),
                           torch.full((h, 1), 3.0, dtype=F32, device=dev)],
                          dim=1),
        "w_o": L.dense_init(gen, (h, dv, d), h * dv, dtype),
        "skip": torch.zeros((inner,), dtype=F32, device=dev),
    }


def mlstm_logical():
    """The logical axes of ``mlstm_params``' leaves."""
    return {"w_up": Logical("embed", "mlp"), "w_gate": Logical("embed", "mlp"),
            "w_q": Logical("mlp", "heads", None),
            "w_k": Logical("mlp", "heads", None),
            "w_v": Logical("mlp", "heads", None),
            "w_if": Logical("mlp", "heads", None),
            "b_if": Logical("heads", None),
            "w_o": Logical("heads", None, "embed"), "skip": Logical("mlp")}


def mlstm_apply(cfg, p, x, cache=None, *, backend: str = "auto"):
    """x: [B,S,D]; cache {"c","n","m"} or None (updated in place).
    Returns (y, cache)."""
    b, s, d = x.shape
    up = x @ p["w_up"]
    gate = x @ p["w_gate"]
    up = shard_act(up, "batch", None, "mlp")
    q = L._proj(up, p["w_q"])
    k = L._proj(up, p["w_k"])
    v = L._proj(up, p["w_v"])
    gif = L._proj(up.to(F32), p["w_if"]) + p["b_if"]
    li, lf = gif[..., 0].contiguous(), _logsig(gif[..., 1])
    state = None
    if cache is not None:
        state = (cache["c"], cache["n"], cache["m"])
    if s == 1 and cache is not None:
        h, state = mlstm_recurrent_ref(q, k, v, li, lf, state)
    else:
        h, state = mlstm(q, k, v, li, lf, state, backend=backend)
    # gated inner stream (h lives in the 2D "inner" width: H * Dv == 2*D),
    # plus a learnable per-channel skip of the up-projected stream
    inner = h.reshape(b, s, -1).to(F32)
    inner = inner * L.silu(gate.to(F32)) + p["skip"] * up.to(F32)
    out = inner.to(x.dtype) @ p["w_o"].reshape(-1, d)
    if cache is not None:
        for name, a in zip(("c", "n", "m"), state):
            cache[name].copy_(a)
    return out, cache


def mlstm_cache(cfg, batch: int, device):
    h, dk = cfg.num_heads, cfg.head_dim
    dv = 2 * cfg.d_model // h
    return {"c": torch.zeros((batch, h, dk, dv), dtype=F32, device=device),
            "n": torch.zeros((batch, h, dk), dtype=F32, device=device),
            "m": torch.full((batch, h), NEG_INF, dtype=F32, device=device)}


def mlstm_cache_logical():
    return {"c": Logical("batch", "heads", None, None),
            "n": Logical("batch", "heads", None),
            "m": Logical("batch", "heads")}


# ===========================================================================
# sLSTM
# ===========================================================================

def slstm_params(gen: Optional[torch.Generator], cfg, dtype=None):
    dtype = dtype or getattr(torch, cfg.dtype)
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    dev = L._device(gen)
    return {
        # input gates: 4 gates (i,f,z,o) from x
        "w_gates": L.dense_init(gen, (d, 4, d), d, dtype),
        "b_gates": torch.cat([torch.zeros((1, d), dtype=F32, device=dev),
                              torch.full((1, d), 3.0, dtype=F32, device=dev),
                              torch.zeros((2, d), dtype=F32, device=dev)],
                             dim=0),
        # block-diagonal recurrent weights per head: [H,4,hd,hd]
        "r_gates": L.dense_init(gen, (h, 4, hd, hd), hd, dtype),
        "w_out": L.dense_init(gen, (d, d), d, dtype),
    }


def slstm_logical():
    """The logical axes of ``slstm_params``' leaves."""
    return {"w_gates": Logical("embed", None, "mlp"),
            "b_gates": Logical(None, "mlp"),
            "r_gates": Logical("heads", None, None, None),
            "w_out": Logical("mlp", "embed")}


def slstm_apply(cfg, p, x, cache=None):
    """Sequential sLSTM. x: [B,S,D]; cache {"c","n","h","m"} or None
    (updated in place). Returns (y, cache)."""
    b, s, d = x.shape
    h = cfg.num_heads
    hd = d // h
    wx = L._proj(x, p["w_gates"]).to(F32) + p["b_gates"]     # [B,S,4,D]
    if cache is not None:
        c, n, hprev, m = (cache[k].to(F32) for k in ("c", "n", "h", "m"))
    else:
        c = torch.zeros((b, d), dtype=F32, device=x.device)
        n = torch.ones((b, d), dtype=F32, device=x.device)
        hprev = torch.zeros((b, d), dtype=F32, device=x.device)
        m = torch.zeros((b, d), dtype=F32, device=x.device)
    r = p["r_gates"].to(F32)
    ys = []
    for t in range(s):
        hh = hprev.reshape(b, h, hd)
        rec = torch.einsum("bhk,hgkj->bghj", hh, r).reshape(b, 4, d)
        g = wx[:, t] + rec
        li = g[:, 0]
        lf = _logsig(g[:, 1])
        z = torch.tanh(g[:, 2])
        o = torch.sigmoid(g[:, 3])
        m_new = torch.maximum(lf + m, li)
        ci = torch.exp(lf + m - m_new)
        zi = torch.exp(li - m_new)
        c = ci * c + zi * z
        n = ci * n + zi
        hprev = o * c / torch.clamp_min(n, 1e-6)
        m = m_new
        ys.append(hprev)
    y = torch.stack(ys, dim=1)                                # [B,S,D]
    out = y.to(x.dtype) @ p["w_out"]
    if cache is not None:
        for name, a in zip(("c", "n", "h", "m"), (c, n, hprev, m)):
            cache[name].copy_(a)
    return out, cache


def slstm_cache(cfg, batch: int, device):
    d = cfg.d_model
    z = torch.zeros((batch, d), dtype=F32, device=device)
    return {"c": z, "n": torch.ones((batch, d), dtype=F32, device=device),
            "h": z.clone(), "m": z.clone()}


def slstm_cache_logical():
    return {k: Logical("batch", "mlp") for k in ("c", "n", "h", "m")}
