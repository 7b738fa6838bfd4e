"""Trace generation a sweep: host milliseconds of the program's
``api.tracegen`` spans (each bucket's traces generated and stacked, in
``Plan.execute``) over its ``api.execute`` spans in the traced window."""
from perfbench.metrics._program_spans import per_span

MOVES = "sim_req_s"


def read(ctx):
    return per_span(ctx, "api.tracegen", "api.execute")
