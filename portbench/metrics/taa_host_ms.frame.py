"""Host ms a traced frame in tpuray.taa's self time (denoise/taa.py:taa)."""
from portbench import spans


def read(ctx):
    if ctx.unit != "frame":
        return None
    return spans.host_ms(ctx.trace, "tpuray.taa")
