"""The flash-attention kernel's share of its roofline: every prefill of
the traced window, one causal launch a layer (its products at the bf16
peak: compute bounds it at these lengths), over the device time of the
kernel (``flash_kernel``, ``flash_tc_kernel``)."""
from perfbench.metrics._common import share
from perfbench.reference import counts, peaks

MOVES = "ttft_p95_ms"


def read(ctx):
    c = ctx.config
    calls = [dict(counts.flash_attention(
        s, c["num_attention_heads"], c["num_key_value_heads"],
        c["head_dim"]), n=c["num_hidden_layers"])
        for s in ctx.calls["prefill"]]
    return share(ctx, ["flash_kernel", "flash_tc_kernel"], calls,
                 peaks.BF16_FLOPS)
