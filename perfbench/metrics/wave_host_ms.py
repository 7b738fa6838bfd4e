"""Host milliseconds a wave: the traced window's time with no device
operation running, over the waves the wavefront engine ran in it (its
counter ``WAVES``); the wave loop's dispatch and sync, and the sweep's
trace generation spread over its waves."""
MOVES = "sim_req_s"


def read(ctx):
    n = ctx.counts.get("waves", 0)
    if not n:
        return None
    return (ctx.trace.window_s - ctx.trace.busy_s) / n * 1e3
