"""Host milliseconds a sweep: the traced window's time with no device
operation running, over the sweeps in it (the API layer's tracegen,
plan and result assembly, and the launches' own host work)."""
MOVES = "sim_req_s"


def read(ctx):
    n = ctx.counts.get("sweeps", 0)
    if not n:
        return None
    return (ctx.trace.window_s - ctx.trace.busy_s) / n * 1e3
