"""The share of the traced stretch in which the device is idle while the
host works inside the port's entry (outside its `*.wait` spans): the idle
time the program's host work causes. `device_idle_pct` less this is the
harness's loop, synchronise and event records."""

from perfbench import trace
from perfbench.metrics import _spans


def read(ctx):
    work = _spans.host_work(ctx.trace)
    lo, hi = ctx.trace.window
    if work is None or hi <= lo:
        return None
    idle = _spans.intersect(trace.gaps(ctx.trace), work)
    return 100.0 * _spans.length(idle) / (hi - lo)
