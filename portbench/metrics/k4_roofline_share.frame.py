"""K4's share of its roofline: the least time of each traced frame's K4
(portbench/counts.py:k4_bound at the frame's pixels, non-sky, failed and
fallback pixels; a sky pixel moves 21 floats, another 39) over K4's
device time in those frames."""
from portbench import counts


def read(ctx):
    if ctx.unit != "frame":
        return None
    us = ctx.trace.us_of(("K4",))
    if us <= 0:
        return None
    least_ms = sum(counts.k4_bound(c["pixels"], c["non_sky"], c["k4_failed"],
                                   c["k4_fallback"])[0] for c in ctx.counts)
    return 100.0 * least_ms * 1e3 / us
