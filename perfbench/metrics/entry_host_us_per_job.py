"""Host time a job inside the port's entry (the spans `asm.<kind>`),
less the time it waits there for the device (`*.wait` spans): what the
program's own Python, checks, allocations and launches cost a job."""

from perfbench.metrics import _spans


def read(ctx):
    work = _spans.host_work(ctx.trace)
    if work is None or not ctx.trace.jobs:
        return None
    return _spans.length(work) / len(ctx.trace.jobs)
