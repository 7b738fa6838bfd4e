"""Device milliseconds of one launch of the event-loop kernel
(``event_loop_kernel``, one launch a sweep bucket), from the trace."""
MOVES = "sim_req_s"


def read(ctx):
    s, n = ctx.trace.kernel("event_loop_kernel")
    return s / n * 1e3 if n else None
