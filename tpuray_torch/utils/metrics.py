"""Per-frame metrics (counterpart of tpuray/utils/metrics.py): wall time per
frame summarised as one JSON line (FrameMetrics), a torch.profiler trace
around a block (profile_trace) and wall-clock stage timing that waits for
the device (StageTimer). The device-side view of a frame (kernels, busy
share) is tpuray_torch/profile_frames.py.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import time

import torch

from tpuray_torch.utils.checkpoint import tree_leaves


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


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler around a block (the CPU, and the card where there is
    one); on exit a Chrome trace (chrome://tracing, Perfetto) is written
    into log_dir. Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _wait_for(result) -> None:
    """Wait until the work queued on each CUDA device holding a tensor of
    `result` is done (tensors on the CPU are ready when they exist)."""
    devices = {x.device for x in tree_leaves(result)
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


class StageTimer:
    """Wall-clock stage timing: time(name, result) adds the block's time to
    stage `name`, after waiting for result's device (a tensor or a nested
    structure of them), so that a stage counts its device work."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def time(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            _wait_for(result)
        self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> str:
        return json.dumps({k: round(v * 1e3, 2) for k, v in self.stages.items()})
