"""Device-idle milliseconds an admission: the traced window's idle time
inside the program's ``serve.admit`` spans (a request's prompt, its
prefill, the merge into the batch cache and the pool's inserts) over
their count."""
from perfbench.metrics._program_spans import per_span

MOVES = "serve_tok_s"


def read(ctx):
    return per_span(ctx, "serve.admit", idle=True)
