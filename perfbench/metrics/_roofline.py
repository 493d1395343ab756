"""The roofline share of a job kind's traced jobs: the least time their
work needs (`perfbench.bounds`) over the device time of every kernel
they launched, whatever its name."""

from perfbench import bounds
from perfbench.harness import log


def share(ctx, work) -> float | None:
    """100 x least seconds / kernel seconds, with work(job) -> (ops,
    bytes) for each traced job; None without kernel time."""
    t = ctx.job_kernel_seconds()
    if t <= 0 or not ctx.jobs:
        return None
    ops = nbytes = 0.0
    seen = {}  # jobs of one slice share their host arrays: count once
    for job in ctx.jobs:
        if id(job) not in seen:
            seen[id(job)] = work(job)
        o, b = seen[id(job)]
        ops += o
        nbytes += b
    least, by = bounds.bound_seconds(ops, nbytes)
    log(f"roofline: {ops:.6g} ops, {nbytes:.6g} B: least {least:.6f} s "
        f"({by}) of {t:.6f} s of kernels")
    return 100.0 * least / t
