"""The NW kernels' share of their roofline (`bounds.nw_work`: the cells
whose offset a path of each pair's exact penalty can reach)."""

from perfbench import bounds
from perfbench.metrics._roofline import share


def read(ctx):
    if ctx.kind != "nw":
        return None
    c = ctx.config
    return share(ctx, lambda job: bounds.nw_work(
        job["read_len"], job["ref_len"], job["outputs"]["penalty"], c["o"],
        c["e"], c["max_len"]))
