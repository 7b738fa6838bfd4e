"""Operations and bytes of the program's kernels and of a served model's
step, counted from the shapes of each call.

Each input byte is read once and each output byte written once, whatever
a kernel reads again. These functions are the yardstick of every
roofline share and of ``serve_mfu``: a change to the program does not
change them.

The simulator's three kernels (the event loop and the two wave passes)
are counted in bytes alone. Their work is integer control flow whose
length a request step takes depends on the policy and on the state
(hits, bypasses, the victim search, the DRAM queue), so no count from the
call's shapes holds it; their shares are of the byte bound, which is never
above the true roofline share.
"""
from __future__ import annotations

from typing import Iterable, Mapping

I32 = F32 = 4
BF16 = 2

def event_loop(n_seeds: int, n_instr: int, n_warps: int, lanes: int,
               n_policies: int, prm: Mapping) -> dict:
    """One launch of the event-loop kernel over a bucket of ``n_seeds``
    traces [I, W, L] and ``n_policies`` policies (N = P·S simulations):
    the traces and policy rows in, each simulation's final state, ready
    times, pointers and ratio snapshots out."""
    n = n_seeds * n_policies
    cells = n_seeds * n_instr * n_warps
    inputs = (cells * lanes * I32          # lines
              + 2 * cells * I32            # pcs, oracle labels
              + n_seeds * n_instr * F32    # compute gap
              + n * 16 * F32               # policy rows
              + n * n_warps)               # PCAL tokens (bool)
    sets_ways = prm["sets"] * prm["ways"]
    state = (3 * sets_ways * I32 + prm["banks"] * F32
             + 3 * prm["dram_channels"] * I32 + prm["eaf_bits"] * I32
             + 2 * I32 + 3 * prm["pc_entries"] * I32
             + 8 * n_warps * I32           # classifier rows, lifetime
             + (12 + 5 + 6) * I32)         # metrics
    outputs = n * (state + 2 * n_warps * I32 + n_instr * n_warps * F32)
    return {"bytes": float(inputs + outputs)}


def decode_attention(lengths: Iterable[int], heads: int, kv_heads: int,
                     head_dim: int, dtype_bytes: int = BF16) -> dict:
    """One paged-decode launch: one query token a row against its first
    ``length`` ring slots; K and V of those slots and the query read,
    the output written; 4·length·D operations per head (q·k and p·v)."""
    lengths = list(lengths)
    rows, kv_len = len(lengths), sum(lengths)
    nbytes = (2 * kv_len * kv_heads * head_dim * dtype_bytes
              + 2 * rows * heads * head_dim * dtype_bytes
              + 2 * rows * I32)
    return {"ops": 4.0 * kv_len * heads * head_dim, "bytes": float(nbytes)}


def flash_attention(seq: int, heads: int, kv_heads: int, head_dim: int,
                    causal: bool = True, dtype_bytes: int = BF16) -> dict:
    """One prefill launch over ``seq`` tokens: Q, K, V read and O written
    once; 4·D operations a head for each (query, key) pair kept by the
    mask (S(S+1)/2 of them when causal)."""
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    nbytes = (2 * seq * heads + 2 * seq * kv_heads) * head_dim * dtype_bytes
    return {"ops": 4.0 * pairs * heads * head_dim, "bytes": float(nbytes)}


def dense_linear_params(cfg: Mapping) -> int:
    """Weights a token passes through in the layers of a dense GQA
    decoder (attention projections and the gated MLP)."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    h, kv, ff = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["intermediate_size"])
    per_layer = d * (h + 2 * kv) * hd + h * hd * d + 3 * d * ff
    return cfg["num_hidden_layers"] * per_layer


def model_flops(cfg: Mapping, prefills: Iterable[int],
                decode_lengths: Iterable[int]) -> float:
    """Model FLOPs of a served dense decoder: 2 per weight per token
    through the layers, the head on each token whose logits are taken
    (the last of a prefill, every decoded token), and attention's two
    products (causal within a prefill; a decoded token at cache length n
    attends to n + 1 positions)."""
    d, hd, h = cfg["hidden_size"], cfg["head_dim"], cfg["num_attention_heads"]
    layers, vocab = cfg["num_hidden_layers"], cfg["vocab_size"]
    lin, head = 2.0 * dense_linear_params(cfg), 2.0 * d * vocab
    total = 0.0
    for s in prefills:
        total += s * lin + head + layers * 4.0 * h * hd * s * (s + 1) / 2
    for n in decode_lengths:
        total += lin + head + layers * 4.0 * h * hd * (n + 1)
    return total


def wave_cache(slots: int, lanes: int, prm: Mapping) -> dict:
    """One cache-pass launch over a wave of ``slots`` warps x ``lanes``:
    the cache, EAF and PC-table state in and out, each slot's classifier
    row in and out, its trace row, ready time, PC, label, token and
    activity in, and nine record fields a request out (time, address,
    victim type: 4 bytes; five flags: 1 byte each)."""
    state = (3 * prm["sets"] * prm["ways"] * I32 + prm["eaf_bits"] * I32
             + 2 * I32 + 3 * prm["pc_entries"] * I32)
    rows = slots * 6 * I32
    inputs = (state + rows + slots * (lanes * I32 + 3 * I32 + 2)
              + 16 * F32)
    outputs = state + rows + slots * lanes * (3 * I32 + 6)
    return {"bytes": float(inputs + outputs)}


def wave_queue(requests: int, prm: Mapping) -> dict:
    """One timing-pass launch over ``requests`` requests: arrival time,
    bank, channel and row (4 bytes each) and four flags in; bank and DRAM
    start (4 bytes each) and the row-hit flag out; the queue carry (two
    words a bank, seven a channel) in and out."""
    carry = (2 * prm["banks"] + 7 * prm["dram_channels"]) * I32
    nbytes = requests * (4 * I32 + 4) + requests * (2 * F32 + 1) + 2 * carry
    return {"bytes": float(nbytes)}
