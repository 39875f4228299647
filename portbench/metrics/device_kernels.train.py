"""Device kernels a train step, counted in the trace (memory copies and sets
left out)."""


def read(ctx):
    if ctx.unit != "step" or not ctx.trace.device_ops:
        return None
    return ctx.trace.kernel_count() / ctx.units
