"""The device trace of a traced run, and what the per-layer readers take
from it.

`profiled` is a copy of tpuray_torch/profile_frames.py:profiled: a
torch.profiler session after SESSION_PAD one-cycle spin kernels, run
again (at most SESSION_ATTEMPTS sessions) while the profiler lost a
kernel record past them; on an H100 it loses a session's first kernel
records, the more the older the process.
"""
from __future__ import annotations

import collections
import time

import torch

SESSION_PAD = 512
SESSION_ATTEMPTS = 5
SPIN = "spin_kernel"
# the program's hand-written kernels, matched as substrings of the device
# kernel names (tpuray_torch/csrc/*.cu)
HAND_WRITTEN = {"K1": "trace_k1", "K2": "trace_k2", "K3": "trace_k3", "K6": "trace_k6",
                "K4": "reproject_variance", "K5": "atrous_step", "K7": "gather_rows"}
WALKS = ("K1", "K2", "K3", "K6")


def which(name: str) -> str | None:
    return next((k for k, v in HAND_WRITTEN.items() if v in name), None)


def is_nccl(name: str) -> bool:
    """A kernel of NCCL's (ncclDevKernel_*, ncclKernel_*): a collective or a
    point-to-point transfer between ranks."""
    return name.startswith(("ncclDevKernel", "ncclKernel"))


def _lost_launches(prof) -> list[int]:
    raw = prof.profiler.kineto_results.events()
    recorded = {e.correlation_id() for e in raw
                if e.device_type() == torch.autograd.DeviceType.CUDA}
    launched = sorted((e for e in raw if "LaunchKernel" in e.name()),
                      key=lambda e: e.start_ns())
    return [i for i, e in enumerate(launched) if e.correlation_id() not in recorded]


def profiled(fn):
    """fn() under torch.profiler after the padding, again while a kernel
    record past the padding was lost -> (profile, host seconds of fn and
    its synchronize, sessions taken)."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, SESSION_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(SESSION_PAD):
                torch.cuda._sleep(1)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        lost = _lost_launches(prof)
        if not lost or lost[-1] < SESSION_PAD:
            return prof, wall, attempt
    raise RuntimeError(f"torch.profiler lost kernels past the {SESSION_PAD} padding kernels "
                       f"in {SESSION_ATTEMPTS} sessions")


class Trace:
    """The device operations (name, start us, end us) of a session but the
    padding spins, and its host operations."""

    def __init__(self, device_ops, host_ops):
        self.device_ops = sorted(device_ops, key=lambda e: e[1])
        self.host_ops = host_ops

    @staticmethod
    def of(prof) -> "Trace":
        """The session's operations; a device-side annotation (the process
        group's "nccl:<collective>" range around its kernels) is no device
        operation."""
        dev, host = [], []
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if SPIN not in e.name and not getattr(e, "is_user_annotation", False):
                    dev.append((e.name, e.time_range.start, e.time_range.end))
            else:
                host.append((e.name, e.time_range.start, e.time_range.end))
        return Trace(dev, host)

    def busy_us(self) -> float:
        """The union of the device operations' intervals."""
        total, cur_s, cur_e = 0.0, None, None
        for _, s, e in self.device_ops:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def by_name(self) -> dict[str, list]:
        """name -> [count, device us]."""
        out = collections.defaultdict(lambda: [0, 0.0])
        for name, s, e in self.device_ops:
            out[name][0] += 1
            out[name][1] += e - s
        return dict(out)

    def kernel_count(self) -> int:
        """Device operations but memory copies and sets."""
        return sum(1 for name, _, _ in self.device_ops
                   if not name.startswith(("Memcpy", "Memset")))

    def us_of(self, kernels) -> float:
        """Device us of the hand-written kernels named in `kernels`."""
        return sum(e - s for name, s, e in self.device_ops if which(name) in kernels)

    def us_not_hand_written(self) -> float:
        """Device us of every operation but the hand-written kernels and
        NCCL's."""
        return sum(e - s for name, s, e in self.device_ops
                   if which(name) is None and not is_nccl(name))

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The longest gaps between device operations, each named by the
        innermost host operation running at its middle."""
        gaps, end = [], None
        for _, s, e in self.device_ops:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        out = []
        for length, s, e in gaps[:top]:
            mid = (s + e) / 2
            running = [(he - hs, name) for name, hs, he in self.host_ops if hs <= mid <= he]
            out.append([min(running)[1] if running else "no host operation recorded",
                        length / 1e6])
        return out

    def top_ops(self, top: int = 10) -> list[list]:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1][1])[:top]
        return [[name, us / 1e6] for name, (_, us) in ops]
