"""Host milliseconds of the residency transactions a step: the
program's ``serve.residency`` spans (every active slot's block accesses
to the pool, and restores) in the traced window over their count, one
an engine step."""
from perfbench.metrics._program_spans import per_span

MOVES = "serve_tok_s"


def read(ctx):
    return per_span(ctx, "serve.residency")
