"""Device-idle milliseconds a decode step: the traced window's idle time
inside the program's ``serve.decode`` spans (the batched decode step:
its host dispatch of every layer's launches) over their count."""
from perfbench.metrics._program_spans import per_span

MOVES = "itl_p95_ms"


def read(ctx):
    return per_span(ctx, "serve.decode", idle=True)
