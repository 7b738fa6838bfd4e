"""Share of a simulator cell's traced window in which no operation ran
on the device (from the profiler's trace)."""
from perfbench.metrics._common import idle_pct

MOVES = "sim_req_s"


def read(ctx):
    return idle_pct(ctx)
