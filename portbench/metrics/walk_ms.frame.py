"""Device milliseconds a frame of the traversal kernels (K1, K2, K3, K6:
trace_k1, trace_k2, trace_k3, trace_k6)."""
from portbench.traceread import WALKS


def read(ctx):
    if ctx.unit != "frame":
        return None
    us = ctx.trace.us_of(WALKS)
    return us / 1e3 / ctx.units if us > 0 else None
