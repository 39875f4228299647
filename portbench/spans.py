"""What the per-layer readers of the program's spans take from a trace.

The program marks its frame's layers with spans (tpuray_torch/utils/
metrics.py: span), CPU ops of the profiler's session named `tpuray.*`,
on the clock of the device's operations: tpuray.frame holds
tpuray.trace_paths (which holds tpuray.wait.hit_count), tpuray.svgf
(which holds tpuray.taa) and tpuray.wait.coverage. A layer's self time is
its spans' intervals less those of the program spans inside them; its
idle time is the part of its self time in which no device operation ran.
A checkout whose program has no spans gives no traced frame: every reader
then returns None.
"""
from __future__ import annotations

FRAME = "tpuray.frame"
WAIT = "tpuray.wait."
# a layer's span -> the prefixes of the program spans inside it that its
# self time leaves out
CHILDREN = {"tpuray.trace_paths": (WAIT,), "tpuray.svgf": ("tpuray.taa",),
            "tpuray.taa": ()}


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def minus(a, b) -> list[tuple[float, float]]:
    """merged(a) less merged(b)."""
    out, b, j = [], merged(b), 0
    for s, e in merged(a):
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def named(trace, prefix: str) -> list[tuple[float, float]]:
    """The intervals of the host operations whose names start with prefix."""
    return [(s, e) for name, s, e in trace.host_ops if name.startswith(prefix)]


def frames(trace) -> int:
    """The traced frames: the tpuray.frame spans not inside another."""
    n, end = 0, None
    for s, e in sorted(named(trace, FRAME), key=lambda iv: (iv[0], -iv[1])):
        if end is None or s >= end:
            n, end = n + 1, e
    return n


def self_time(trace, layer: str) -> list[tuple[float, float]]:
    """The layer's spans less the program spans inside them."""
    inner = [iv for p in CHILDREN[layer] for iv in named(trace, p)]
    return minus(named(trace, layer), inner)


def host_ms(trace, layer: str) -> float | None:
    """Host ms a traced frame in the layer's self time."""
    n = frames(trace)
    return length(self_time(trace, layer)) / 1e3 / n if n else None


def idle_ms(trace, layer: str) -> float | None:
    """Device-idle ms a traced frame while the host was in the layer's self
    time: its intervals less the union of the device operations'."""
    n = frames(trace)
    if not n:
        return None
    busy = [(s, e) for _, s, e in trace.device_ops]
    return length(minus(self_time(trace, layer), busy)) / 1e3 / n


def wait_ms(trace) -> float | None:
    """Host ms a traced frame in the program's blocking device reads."""
    n = frames(trace)
    return length(merged(named(trace, WAIT))) / 1e3 / n if n else None
