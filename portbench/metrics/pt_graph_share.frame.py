"""The share of traced frames whose path tracer output came from replays
of CUDA graphs captured before them, in %: the program's pt_graph counter
(1 or 0 a frame) over its last ctx.units frame records
(tpuray_torch/utils/metrics.py:frame_records; the graphs:
tpuray_torch/integrator/path_graphs.py). A program whose frame records
have no pt_graph counter gives nothing."""


def read(ctx):
    if ctx.unit != "frame":
        return None
    try:
        from tpuray_torch.utils.metrics import frame_records
    except ImportError:  # a program that keeps no frame records
        return None
    recs = frame_records()[-ctx.units:]
    if not recs or any("pt_graph" not in r for r in recs):
        return None
    return 100.0 * sum(r["pt_graph"] for r in recs) / len(recs)
