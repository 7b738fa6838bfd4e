"""Share of the pool's block accesses in the traced window that found
their block resident (``pool.access`` calls counted by the benchmark's
wrapper, misses by the pool's own ``fetches``)."""
MOVES = "serve_tok_s"


def read(ctx):
    acc = ctx.counts.get("pool_accesses", 0)
    if not acc:
        return None
    return 100.0 * (acc - ctx.counts["pool_fetches"]) / acc
