"""Per-frame metrics and the program's own trace (counterpart of
tpuray/utils/metrics.py).

- FrameMetrics: wall time per frame summarised as one JSON line (the CLI's).
- span(name): a named interval of the host's work, recorded only while a
  torch.profiler session records, as an ordinary CPU op of that session,
  so on the clock of the device's kernels. The frame's spans, nested:
  tpuray.frame (render/renderer.py:Renderer.step,
  dist/frame.py:render_frame_sharded, cli/main.py's render --elastic)
  holds tpuray.trace_paths
  (integrator/path_tracer.py:trace_paths, which holds
  tpuray.wait.hit_count, host_count's read), tpuray.svgf
  (denoise/svgf.py:svgf_pipeline, which holds tpuray.taa, denoise/taa.py)
  and tpuray.wait.coverage (render/renderer.py:LaggedScalar.read).
- count(key, value): a counter of the frame being rendered, kept while a
  profiler records: lanes (its primary rays), shaded_lanes (the lanes its
  bounce loop ran on), residual (whether compaction's residual pass ran),
  coverage (its share of primary hits, the device scalar render_frame
  makes), frame_idx. frame_records() returns the last RECORDS frames'.
- profile_trace(log_dir): a torch.profiler session around a block, written
  as a Chrome trace (the CLI's render --trace).

With no profiler recording, a span costs one check of the profiler's
state and a count one test of a module variable: nothing is allocated,
read from the device or launched. One thread renders at a time.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import time

import torch

FRAME = "tpuray.frame"
RECORDS = 1024  # frame records kept, the newest

_profiling = torch.autograd._profiler_enabled
_records: collections.deque = collections.deque(maxlen=RECORDS)
_open: dict | None = None  # the record of the frame being rendered


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


class _Null:
    """The span while no profiler records (contextlib.nullcontext's
    varargs exit costs more)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_NULL = _Null()


class _FrameSpan:
    """tpuray.frame while a profiler records: the span, and the frame's
    record, kept when the frame completes."""

    __slots__ = ("_op", "_outer")

    def __init__(self):
        self._op = torch._C._profiler._RecordFunctionFast(FRAME)

    def __enter__(self):
        global _open
        self._outer = _open
        _open = dict(frame_idx=None, lanes=0, shaded_lanes=0, residual=False,
                     coverage=None)
        self._op.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        global _open
        if exc_type is None:
            _records.append(_open)
        _open = self._outer
        return self._op.__exit__(exc_type, exc, tb)


def span(name: str):
    """A context manager: while a torch.profiler session records, a CPU op
    named `name` in it (FRAME also opens a frame record); otherwise a
    shared null context. The op is torch's _RecordFunctionFast, an
    ordinary CPU op: record_function makes a user annotation, which the
    profiler also emits as a device-side event, so a device trace would
    count the span as device work."""
    if not _profiling():
        return _NULL
    if name == FRAME:
        return _FrameSpan()
    return torch._C._profiler._RecordFunctionFast(name)


def count(key: str, value) -> None:
    """Set counter `key` of the open frame record; nothing without one."""
    if _open is not None:
        _open[key] = value


def frame_records() -> list[dict]:
    """The kept frame records, oldest first, with coverage read as a float
    here (a frame keeps the device scalar and reads nothing)."""
    return [dict(r, coverage=None if r["coverage"] is None else float(r["coverage"]))
            for r in _records]
