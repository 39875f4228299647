"""Per-frame metrics (counterpart of tpuray/utils/metrics.py:FrameMetrics):
wall time per frame, summarised as one JSON line. The device-side view of
a frame (kernels, busy share) is tpuray_torch/profile_frames.py.
"""
from __future__ import annotations

import json
import statistics


class FrameMetrics:
    def __init__(self, width: int, height: int, depth: int):
        self.width = width
        self.height = height
        # traversals a pixel: depth x (nearest + env shadow + point shadow)
        self.rays_per_frame = width * height * depth * 3
        self.times: list[float] = []

    def record(self, seconds: float) -> None:
        self.times.append(seconds)

    def summary(self) -> str:
        """{"frames", "first_frame_ms", "median_ms", "fps", "mrays_per_s"};
        the median leaves out the first frame (kernel build and warm-up)."""
        if not self.times:
            return "{}"
        steady = self.times[1:] or self.times
        ms = statistics.median(steady) * 1e3
        return json.dumps({
            "frames": len(self.times),
            "first_frame_ms": round(self.times[0] * 1e3, 2),
            "median_ms": round(ms, 2),
            "fps": round(1e3 / ms, 2),
            "mrays_per_s": round(self.rays_per_frame / ms / 1e3, 1),
        })
