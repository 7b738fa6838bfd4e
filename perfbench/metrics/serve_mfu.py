"""The whole serving step's share of the card's bf16 peak over the
traced window: the model FLOPs of every prefill and every decoded token
(``reference.counts.model_flops``) over the window's length times 989
TFLOP/s."""
from perfbench.reference import counts, peaks

MOVES = "serve_tok_s"


def read(ctx):
    flops = counts.model_flops(
        ctx.config, ctx.calls["prefill"],
        [n for step in ctx.calls["decode_active"] for n in step])
    if flops <= 0 or ctx.trace.window_s <= 0:
        return None
    return 100.0 * flops / (ctx.trace.window_s * peaks.BF16_FLOPS)
