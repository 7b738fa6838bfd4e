"""The timing-pass kernel's share of its byte bound: one launch a wave
over its B x L requests (their fields in, two start times and a flag
out, the queue carry in and out) over the device time of
``wave_queue_kernel``. The operation side is not read
(``reference/counts.py``)."""
from perfbench.metrics._common import share
from perfbench.reference import counts

MOVES = "sim_req_s"


def read(ctx):
    n = ctx.counts.get("launches.wave_queue", 0)
    if not n:
        return None
    b, lanes = ctx.calls["wave"][0]
    calls = [dict(counts.wave_queue(b * lanes, ctx.config["sim_params"]),
                  n=n)]
    return share(ctx, ["wave_queue_kernel"], calls)
