"""The paged decode-attention kernel's share of its roofline: for every
decode step of the traced window, one launch a layer over all slots'
rings up to their lengths (K and V read once: memory bounds it), over
the device time of its two kernels (``split_kernel``,
``combine_kernel``)."""
from perfbench.metrics._common import share
from perfbench.reference import counts, peaks

MOVES = "serve_tok_s"


def read(ctx):
    c = ctx.config
    calls = [dict(counts.decode_attention(
        lens, c["num_attention_heads"], c["num_key_value_heads"],
        c["head_dim"]), n=c["num_hidden_layers"])
        for lens in ctx.calls["decode"]]
    return share(ctx, ["split_kernel", "combine_kernel"], calls,
                 peaks.BF16_FLOPS)
