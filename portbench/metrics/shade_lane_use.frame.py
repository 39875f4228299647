"""The primary hits over the lanes the bounce loop shaded, in %, over the
traced frames: sum of coverage x lanes over sum of shaded_lanes, from the
program's last ctx.units frame records
(tpuray_torch/utils/metrics.py:frame_records; lanes are the primary rays,
shaded_lanes the compaction budget, plus the primary rays when the
residual pass ran, or the primary rays uncompacted)."""


def read(ctx):
    if ctx.unit != "frame":
        return None
    try:
        from tpuray_torch.utils.metrics import frame_records
    except ImportError:  # a program that keeps no frame records
        return None
    recs = [r for r in frame_records()[-ctx.units:] if r["coverage"] is not None]
    if not recs:
        return None
    shaded = sum(r["shaded_lanes"] for r in recs)
    hits = sum(r["coverage"] * r["lanes"] for r in recs)
    return 100.0 * hits / shaded if shaded else 0.0
