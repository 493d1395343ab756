"""Device kernels the traced jobs launched, per traced job."""


def read(ctx):
    if not ctx.trace.jobs or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / len(ctx.trace.jobs)
