"""Device-idle ms a traced frame while the host was in tpuray.svgf's self
time (denoise/svgf.py:svgf_pipeline: K4, the a-trous chain and modulate
as the host issues them, less tpuray.taa inside it): its intervals less
the union of the device operations'."""
from portbench import spans


def read(ctx):
    if ctx.unit != "frame":
        return None
    return spans.idle_ms(ctx.trace, "tpuray.svgf")
