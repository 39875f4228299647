"""Host ms a traced frame in tpuray.trace_paths's self time
(integrator/path_tracer.py:trace_paths: the primary walk, compaction,
the bounce loop and the env lookup, less tpuray.wait.hit_count inside
it)."""
from portbench import spans


def read(ctx):
    if ctx.unit != "frame":
        return None
    return spans.host_ms(ctx.trace, "tpuray.trace_paths")
