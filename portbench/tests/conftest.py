"""Fixtures of the benchmark's own tests (run from the repository root:
`python -m pytest portbench/tests -q`; the tier-1 suite does not collect
them). CPU runs use small traffic: the kind and the code paths of the
cells, at a few dozen pixels."""
from __future__ import annotations

import pytest
import torch

from portbench import spec

SMALL = dict(width=40, height=24, warmup_frames=3, check_frames=2)


def bench_for(cell: str) -> dict:
    """BENCHMARK.json, with the cell's held entries where it is held out."""
    b = spec.benchmark()
    if any(w["name"] == cell for w in b["workloads"]):
        return b
    return spec.with_held(b, cell)


@pytest.fixture
def small_traffic(monkeypatch):
    """Every traffic mix at SMALL's size."""
    orig = spec.traffic

    def small(name):
        return dict(orig(name), **SMALL)
    monkeypatch.setattr(spec, "traffic", small)
    return small


@pytest.fixture
def card():
    """Skips without a CUDA device (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
