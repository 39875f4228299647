"""kernels layer of tpuray_torch (see the package docstring).

reset_launches and launches read every wrapper's launch counter at once:
K1-K3 (trace.py), K6 (trace_chunked.py), K4 (reproject.py), K5 (atrous.py)
and K7 (gather.py).
"""
from __future__ import annotations


def _counted():
    from tpuray_torch.kernels import atrous, gather, reproject, trace, trace_chunked
    return trace, trace_chunked, reproject, atrous, gather


def reset_launches() -> None:
    for m in _counted():
        m.reset_launches()


def launches() -> dict[str, int]:
    """{"k1": n, ..., "k7": n}: the launches since the last reset."""
    out = {}
    for m in _counted():
        out.update(m.LAUNCHES)
    return out
