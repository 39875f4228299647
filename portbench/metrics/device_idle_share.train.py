"""Share of a train step's unprofiled wall time in which no device
operation ran: 1 - (union of the device operations' intervals over the
traced steps) / (the traced steps' count x the window's wall seconds a
step)."""


def read(ctx):
    if ctx.unit != "step" or not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / 1e6 / (ctx.units * ctx.unit_wall_s))
