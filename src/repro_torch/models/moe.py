"""Mixture-of-Experts FFN with capacity-based gather/scatter dispatch, in
torch (port of ``repro.models.moe``).

Dispatch is sort-free: positions-within-expert come from an exclusive
cumsum over the one-hot assignment matrix, then tokens are gathered into
an ``[E, C, D]`` expert buffer (overflow beyond capacity C is dropped)
and the expert outputs gathered back with the router weights.

The router runs in float32 and picks each token's top k experts with ties
toward the lower expert index, as ``jax.lax.top_k`` does (a stable
descending sort; ``torch.topk`` breaks ties otherwise). The expert
products are batched matrix products (the reference's einsums; it has no
Pallas kernel for them either).

Under a ``sharding_ctx`` whose mesh has a ``pod`` or ``data`` axis of more
than one entry, tokens split into that many groups by batch row, each
group dispatched on its own with its own capacity, and the aux losses
averaged (the reference's grouped dispatch): on one device a loop over the
groups.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import activation, dense_init
from repro_torch.sharding import Logical, current_mesh, shard_act

F32 = torch.float32
I32 = torch.int32


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def moe_params(gen: Optional[torch.Generator], cfg, dtype=None):
    """Router ``[D, E]`` in float32; ``w_gate`` / ``w_up`` ``[E, D, F]`` and
    ``w_down`` ``[E, F, D]`` in the model's dtype. ``gen=None`` gives meta
    tensors of the right shapes."""
    dtype = dtype or getattr(torch, cfg.dtype)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": dense_init(gen, (d, e), d, F32),
            "w_gate": dense_init(gen, (e, d, f), d, dtype),
            "w_up": dense_init(gen, (e, d, f), d, dtype),
            "w_down": dense_init(gen, (e, f, d), f, dtype)}


def moe_logical():
    """The logical axes of ``moe_params``' leaves."""
    return {"router": Logical("embed", None),
            "w_gate": Logical("expert", "embed", "mlp"),
            "w_up": Logical("expert", "embed", "mlp"),
            "w_down": Logical("expert", "mlp", "embed")}


def capacity(cfg, num_tokens: int) -> int:
    """Slots an expert takes from ``num_tokens`` tokens: the reference's
    formula literally (its ``int`` and roundings) — a multiple of 128 from
    128 up, else at least 8 and never more than all the assignments
    rounded up to 8 (8 at a decode of 2 tokens, 384 for OLMoE's 2048)."""
    tk = num_tokens * cfg.num_experts_per_tok
    c = int(tk * cfg.capacity_factor / cfg.num_experts)
    if c >= 128:
        return _round_up(c, 128)
    return max(8, _round_up(min(max(c, 8), tk), 8))


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, largest
    first and ties toward the lower index (``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(cfg, p, x):
    """x: [B, S, D] -> (y, aux_loss)."""
    mesh = current_mesh()
    batch_axes = tuple(a for a in ("pod", "data")
                       if mesh is not None and a in mesh.axis_names
                       and mesh.shape[a] > 1)
    g = 1
    for a in batch_axes:
        g *= mesh.shape[a]
    b = x.shape[0]
    if g > 1 and b % g == 0:
        outs = [_moe_apply_dense(cfg, p, xb, in_manual=True)
                for xb in x.reshape(g, b // g, *x.shape[1:])]
        return (torch.stack([y for y, _ in outs]).reshape(x.shape),
                torch.stack([a for _, a in outs]).mean())
    return _moe_apply_dense(cfg, p, x)


def _router_logits(xf, router):
    """The router's logits [T, E] in float32 (the reference's einsum)."""
    return xf.to(F32) @ router


def _moe_apply_dense(cfg, p, x, in_manual: bool = False):
    """Capacity dispatch over the token set it is handed (the whole batch,
    or one group of the grouped dispatch: ``in_manual`` skips the
    activation-sharding constraints)."""
    b, s, d = x.shape
    t = b * s
    k = cfg.num_experts_per_tok
    e = cfg.num_experts
    xf = x.reshape(t, d)

    logits = _router_logits(xf, p["router"])                         # [T,E]
    probs = torch.softmax(logits, dim=-1)
    weights, eidx = top_k(probs, k)                                  # [T,k]
    weights = weights / torch.clamp_min(
        torch.sum(weights, dim=-1, keepdim=True), 1e-9)

    # load-balancing auxiliary loss (Switch-style)
    density = torch.mean(F.one_hot(eidx[:, 0], e).to(F32), dim=0)
    density_prob = torch.mean(probs, dim=0)
    aux_loss = e * torch.sum(density * density_prob)

    # position-within-expert via exclusive cumsums over one-hot assignments
    onehot = F.one_hot(eidx, e).to(I32)                              # [T,k,E]
    assign = torch.sum(onehot, dim=1)                                # [T,E]
    pos_base = torch.cumsum(assign, dim=0) - assign                  # excl. over T
    intra = torch.cumsum(onehot, dim=1) - onehot                     # [T,k,E]
    pos = pos_base[:, None, :] + intra
    pos_tk = torch.sum(pos * onehot, dim=-1)                         # [T,k]

    cap = capacity(cfg, t)
    keep = pos_tk < cap
    dest = torch.where(keep, eidx * cap + pos_tk, e * cap)           # drop row

    # dispatch: a slot -> token index scatter (the drop row at e·cap takes
    # every dropped assignment, duplicates and all, and is sliced off),
    # then a row gather
    t_flat = torch.arange(t, dtype=I32, device=x.device).repeat_interleave(k)
    slot_token = torch.zeros((e * cap + 1,), dtype=I32, device=x.device)
    slot_token[dest.reshape(-1)] = t_flat + 1
    slot_token = slot_token[: e * cap]
    filled = slot_token > 0
    buf = xf[torch.clamp_min(slot_token - 1, 0).long()]              # [E*C,D]
    buf = torch.where(filled[:, None], buf, 0).reshape(e, cap, d)
    if not in_manual:
        buf = shard_act(buf, "expert", "capacity", None)

    act = activation(cfg.act)
    h = act(torch.bmm(buf, p["w_gate"]))
    h = h * torch.bmm(buf, p["w_up"])
    if not in_manual:
        h = shard_act(h, "expert", "capacity", "mlp")
    y = torch.bmm(h, p["w_down"])
    if not in_manual:
        y = shard_act(y, "expert", "capacity", None)

    # gather back and combine with the router weights in float32
    y_flat = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))], dim=0)
    gathered = y_flat[dest.reshape(-1)].reshape(t, k, d)
    out = torch.sum(gathered.to(F32) * weights[..., None], dim=1)
    return out.reshape(b, s, d).to(x.dtype), aux_loss
