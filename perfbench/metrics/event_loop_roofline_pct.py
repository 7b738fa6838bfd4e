"""The event-loop kernel's share of its byte bound: the least time of each
launch (its traces and policy rows in, its final states out, at HBM
bandwidth) over the kernel's device time in the trace. Its request steps
are data-dependent integer work that no count from the shapes holds, so
the operation side is not read (``reference/counts.py``)."""
from perfbench.metrics._common import share
from perfbench.reference import counts

MOVES = "sim_req_s"


def read(ctx):
    p = ctx.calls["policies"][0]
    prm = ctx.config["sim_params"]
    calls = [counts.event_loop(flat, i, w, l, p, prm)
             for flat, i, w, l in ctx.calls["sweep"]]
    return share(ctx, ["event_loop_kernel"], calls)
