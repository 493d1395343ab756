"""The share of the traced stretch in which no kernel, copy or set ran on
the device (`trace.Trace.window`)."""

from perfbench import trace


def read(ctx):
    lo, hi = ctx.trace.window
    if hi <= lo or not (ctx.trace.kernels or ctx.trace.copies):
        return None
    return 100.0 * (1.0 - trace.busy_us(ctx.trace) / (hi - lo))
