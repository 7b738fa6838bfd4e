"""Engine steps that admitted sequences spent stalled on block fetches,
per token decoded, over the traced window (the requests'
``stall_steps``)."""
MOVES = "serve_tok_s"


def read(ctx):
    tok = ctx.counts.get("tokens", 0)
    return ctx.counts["stall_steps"] / tok if tok else None
