"""Host ms a traced frame in the program's blocking device reads, the
tpuray.wait.* spans: compaction's hit-count read
(integrator/path_tracer.py:host_count) and the Renderer's lagged coverage
read (render/renderer.py:LaggedScalar.read)."""
from portbench import spans


def read(ctx):
    if ctx.unit != "frame":
        return None
    return spans.wait_ms(ctx.trace)
