"""K5's share of its roofline: the least time of each traced frame's
a-trous chain (portbench/counts.py:k5_bound at the frame's pixels and
non-sky pixels) over K5's device time in those frames."""
from portbench import counts


def read(ctx):
    if ctx.unit != "frame":
        return None
    us = ctx.trace.us_of(("K5",))
    if us <= 0:
        return None
    least_ms = sum(counts.k5_bound(c["pixels"], c["non_sky"], ctx.iterations)[0]
                   for c in ctx.counts)
    return 100.0 * least_ms * 1e3 / us
