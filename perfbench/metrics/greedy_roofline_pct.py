"""The greedy kernel's share of its roofline (`bounds.greedy_work`, from
the steps each pair's walk took)."""

from perfbench import bounds
from perfbench.metrics._roofline import share


def read(ctx):
    if ctx.kind != "greedy":
        return None
    c = ctx.config
    return share(ctx, lambda job: bounds.greedy_work(
        job["outputs"]["steps"], c["k"], c["max_len"]))
