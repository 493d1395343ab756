"""The LEAP kernel's share of its roofline (`bounds.leap_work`, from each
pair's verdict and pass energy)."""

from perfbench import bounds
from perfbench.metrics._roofline import share


def read(ctx):
    if ctx.kind != "leap":
        return None
    c = ctx.config
    return share(ctx, lambda job: bounds.leap_work(
        job["outputs"]["passed"], job["outputs"]["penalty"], c["k"],
        c["max_len"], c["leap_af_threshold"]))
