"""Device-idle ms a traced frame while the host was in tpuray.trace_paths's
self time (integrator/path_tracer.py:trace_paths: the primary walk,
compaction, the bounce loop and the env lookup, less
tpuray.wait.hit_count inside it): its intervals less the union of the
device operations'."""
from portbench import spans


def read(ctx):
    if ctx.unit != "frame":
        return None
    return spans.idle_ms(ctx.trace, "tpuray.trace_paths")
