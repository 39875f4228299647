"""kernels layer of tpuray_torch (see the package docstring).

reset_launches and launches read every wrapper's launch counter at once:
K1-K3 (trace.py), K6 (trace_chunked.py), K4 (reproject.py), K5 (atrous.py),
K7 (gather.py) and TAA (taa.py). A wrapper counts the launches it makes
from Python; a replayed CUDA graph makes none, so its launches, tallied as
it was captured, are added at each replay (add_launches;
integrator/path_graphs.py).
"""
from __future__ import annotations


def _counted():
    from tpuray_torch.kernels import atrous, gather, reproject, taa, trace, trace_chunked
    return trace, trace_chunked, reproject, atrous, gather, taa


def reset_launches() -> None:
    for m in _counted():
        m.reset_launches()


def launches() -> dict[str, int]:
    """{"k1": n, ..., "k7": n, "taa": n}: the launches since the last reset."""
    out = {}
    for m in _counted():
        out.update(m.LAUNCHES)
    return out


def add_launches(tally: dict[str, int]) -> None:
    """Add launches that no wrapper call made: {"k1": n, ...}."""
    for m in _counted():
        for k in m.LAUNCHES:
            m.LAUNCHES[k] += tally.get(k, 0)
