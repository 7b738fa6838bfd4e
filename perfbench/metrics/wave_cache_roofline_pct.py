"""The cache-pass kernel's share of its byte bound: one launch a wave of
B slots x L lanes (its state, rows and records through HBM) over the
device time of ``wave_cache_kernel``. The operation side is not read:
a request's work is data-dependent integer control flow
(``reference/counts.py``)."""
from perfbench.metrics._common import share
from perfbench.reference import counts

MOVES = "sim_req_s"


def read(ctx):
    n = ctx.counts.get("launches.wave_cache", 0)
    if not n:
        return None
    b, lanes = ctx.calls["wave"][0]
    calls = [dict(counts.wave_cache(b, lanes, ctx.config["sim_params"]),
                  n=n)]
    return share(ctx, ["wave_cache_kernel"], calls)
