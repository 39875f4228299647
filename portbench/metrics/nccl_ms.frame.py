"""Device milliseconds a traced frame of NCCL's kernels on this rank: the
union of their intervals (the halo exchanges before K4 and each a-trous
step, dist/frame.py:_exchange; the final rows' gather,
dist/sharding.py:gather_rows; the command's broadcast). A kernel that
waits for a slower rank counts its wait. A trace without NCCL kernels
gives nothing."""
from portbench import spans
from portbench.traceread import is_nccl


def read(ctx):
    if ctx.unit != "frame":
        return None
    ops = [(s, e) for name, s, e in ctx.trace.device_ops if is_nccl(name)]
    return spans.length(spans.merged(ops)) / 1e3 / ctx.units if ops else None
