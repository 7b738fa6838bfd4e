"""Plain Qwen3 decoder forward in float32, and the benchmark's weights.

The architecture of Qwen/Qwen3-1.7B as published: a dense decoder of
pre-norm blocks, each RMSNorm -> grouped-query attention (16 query and 8
key/value heads of 128, per-head RMSNorm on queries and keys before
rotary embedding, rotate-half convention, theta 1e6, causal softmax) ->
residual, then RMSNorm -> SwiGLU MLP (silu(x Wg) * (x Wu)) Wd ->
residual; a final RMSNorm and the tied embedding as the head. Every norm
multiplies by ``1 + w``: the weights are kept as offsets from one, in the
program's parameter layout, and both sides are handed the same numbers.

``make_weights`` draws the benchmark's weights on the card from the
seed, in the type they are served in, in a few large calls; the
reference draws them again from the same seed rather than reading the
program's. ``forward_logits`` runs one sequence layer by layer, with the
attention in blocks of queries, and returns the logits at the positions
asked for. With ``fp8`` every weight matrix is first rounded to
float8 e4m3 with a scale per output column: the lower-precision control.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence

import torch

F32 = torch.float32

NORMS = ("norm1", "norm2", "attn.q_norm", "attn.k_norm")
#: the norms' offsets are drawn at this scale, so that a norm's weight
#: takes part in the comparison
NORM_STD = 0.1


def padded_vocab(cfg: Mapping) -> int:
    return -(-cfg["vocab_size"] // 256) * 256


def shapes(cfg: Mapping) -> Dict[str, tuple]:
    """Every parameter's shape and fan-in, in the program's layout:
    ``{name: (shape, fan_in)}``; fan-in 0 marks a norm."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    h, kv, ff = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["intermediate_size"])
    out = {"embed": ((padded_vocab(cfg), d), -1), "final_norm": ((d,), 0)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out.update({
            p + "norm1": ((d,), 0), p + "norm2": ((d,), 0),
            p + "attn.q_norm": ((hd,), 0), p + "attn.k_norm": ((hd,), 0),
            p + "attn.wq": ((d, h, hd), d), p + "attn.wk": ((d, kv, hd), d),
            p + "attn.wv": ((d, kv, hd), d),
            p + "attn.wo": ((h, hd, d), h * hd),
            p + "mlp.w_gate": ((d, ff), d), p + "mlp.w_up": ((d, ff), d),
            p + "mlp.w_down": ((ff, d), ff)})
    return out


def make_weights(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights for ``seed``: matrices in the configuration's type
    (``torch_dtype``) from one normal draw (scale 1/sqrt(fan-in), the
    embedding 0.02), norm offsets in float32 from another (scale
    ``NORM_STD``), as views of the two buffers."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sh = shapes(cfg)
    mats = {k: v for k, v in sh.items() if v[1] != 0}
    norms = {k: v for k, v in sh.items() if v[1] == 0}
    n_mat = sum(math.prod(s) for s, _ in mats.values())
    n_norm = sum(math.prod(s) for s, _ in norms.values())
    flat = torch.randn(n_mat, generator=gen, device=device,
                       dtype=getattr(torch, cfg["torch_dtype"]))
    nflat = torch.randn(n_norm, generator=gen, device=device, dtype=F32)
    nflat.mul_(NORM_STD)
    out, at = {}, 0
    for k, (s, fan_in) in mats.items():
        n = math.prod(s)
        t = flat[at:at + n].view(s)
        t.mul_(0.02 if fan_in < 0 else 1.0 / math.sqrt(fan_in))
        out[k], at = t, at + n
    at = 0
    for k, (s, _) in norms.items():
        n = math.prod(s)
        out[k], at = nflat[at:at + n].view(s), at + n
    return out


def fp8_round(w: torch.Tensor, dim: int) -> torch.Tensor:
    """A 2-D ``w`` rounded to float8 e4m3 with one scale per slice across
    ``dim`` (the slice's amax maps to 448), and back to float32."""
    w = w.to(F32)
    scale = w.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).to(F32) * scale


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=F32, device=x.device) / half)
    ang = pos[:, None].to(F32) * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, block: int) -> torch.Tensor:
    """Causal grouped-query attention of [S, H, D] queries over [S, Kv,
    D] keys and values, in blocks of ``block`` queries."""
    s, h, d = q.shape
    g = h // k.shape[1]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(d)
    for a in range(0, s, block):
        b = min(a + block, s)
        logits = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * scale
        mask = (torch.arange(a, b, device=q.device)[:, None]
                >= torch.arange(b, device=q.device)[None, :])
        logits = logits.masked_fill(~mask, float("-inf"))
        out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(logits, -1),
                                v[:b])
    return out


def forward_logits(cfg: Mapping, weights: Mapping[str, torch.Tensor],
                   tokens: torch.Tensor, positions: Sequence[int],
                   fp8: bool = False, block: int = 1024) -> torch.Tensor:
    """Float32 logits [len(positions), padded vocab] of one sequence
    ``tokens`` [S] at the given positions. ``weights`` are the
    benchmark's (any float type); each is taken to float32 (or through
    fp8, with ``fp8``) as its layer runs."""
    eps, theta = cfg["rms_norm_eps"], float(cfg["rope_theta"])
    h, kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])

    def mat(name, n_in=1):
        """Weight ``name`` as a float32 [in, out] matrix (its first
        ``n_in`` axes are the input), through fp8 per output column with
        ``fp8``."""
        w = weights[name]
        w = w.reshape(math.prod(w.shape[:n_in]), -1)
        return fp8_round(w, 0) if fp8 else w.to(F32)

    embed = weights["embed"]
    embed = fp8_round(embed, 1) if fp8 else embed.to(F32)
    x = embed[tokens.long()]
    s = x.shape[0]
    pos = torch.arange(s, device=x.device)
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        nw = {n: weights[p + n].to(F32) for n in NORMS}
        y = _rms(x, nw["norm1"], eps)
        q = (y @ mat(p + "attn.wq")).view(s, h, hd)
        k = (y @ mat(p + "attn.wk")).view(s, kv, hd)
        v = (y @ mat(p + "attn.wv")).view(s, kv, hd)
        q = _rope(_rms(q, nw["attn.q_norm"], eps), pos, theta)
        k = _rope(_rms(k, nw["attn.k_norm"], eps), pos, theta)
        o = _attention(q, k, v, block).reshape(s, h * hd)
        x = x + o @ mat(p + "attn.wo", 2)
        y = _rms(x, nw["norm2"], eps)
        gate = torch.nn.functional.silu(y @ mat(p + "mlp.w_gate"))
        x = x + (gate * (y @ mat(p + "mlp.w_up"))) @ mat(p + "mlp.w_down")
    xs = _rms(x[list(positions)], weights["final_norm"].to(F32), eps)
    return xs @ embed.T


def served_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> List[float]:
    """How far below the reference's best logit each served token's
    logit lies, position by position."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, tokens.long().view(-1, 1))[:, 0]
    return (best - got).tolist()
