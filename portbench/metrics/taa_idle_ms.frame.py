"""Device-idle ms a traced frame while the host was in tpuray.taa's self
time (denoise/taa.py:taa): its intervals less the union of the device
operations'."""
from portbench import spans


def read(ctx):
    if ctx.unit != "frame":
        return None
    return spans.idle_ms(ctx.trace, "tpuray.taa")
