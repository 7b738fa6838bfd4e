"""The event engine's finalize a sweep: host milliseconds of the
program's ``event.finalize`` spans (each simulation's outputs, one by
one, after the event loop) over its ``api.execute`` spans in the traced
window."""
from perfbench.metrics._program_spans import per_span

MOVES = "sim_req_s"


def read(ctx):
    return per_span(ctx, "event.finalize", "api.execute")
