"""Device-idle milliseconds a wave: the traced window's idle time inside
the program's ``wave.step`` spans (one iteration of the wave loop: its
dispatch, both passes' launches and the wait on the exit test) over
their count."""
from perfbench.metrics._program_spans import per_span

MOVES = "sim_req_s"


def read(ctx):
    return per_span(ctx, "wave.step", idle=True)
