"""Host ms a traced frame in tpuray.svgf's self time
(denoise/svgf.py:svgf_pipeline: K4, the a-trous chain and modulate as
the host issues them, less tpuray.taa inside it)."""
from portbench import spans


def read(ctx):
    if ctx.unit != "frame":
        return None
    return spans.host_ms(ctx.trace, "tpuray.svgf")
