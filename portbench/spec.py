"""Find a cell's files by name.

BENCHMARK.json (at the checkout's root) lists the cells; a cell names a
configuration (configs/<config>.json) and a traffic mix
(traffic/<traffic>.json); each per-layer metric has a reader
(metrics/<metric>.py); a cell's correctness limits are
limits/<cell>.json where that exists, else limits/<traffic kind>.json.
A cell held out of BENCHMARK.json keeps its entries in held/<cell>.json
(with_held), for the tests and for the PR that brings it back.
Adding a cell, configuration, traffic mix or metric is adding files and
entries: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def with_held(bench: dict, cell_name: str) -> dict:
    """A copy of `bench` with the entries of held/<cell>.json added: its
    configuration, cell and metrics, and the cell named in the workloads
    of the metrics it also reports."""
    held = load_json(HERE / "held" / f"{cell_name}.json")
    out = json.loads(json.dumps(bench))
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        out[group] += held[group]
    for m in out["end_to_end"] + out["per_layer"]:
        if m["name"] in held["also_reports"]:
            m["workloads"].append(cell_name)
    return out


def limits(cell_name: str, kind: str) -> dict:
    own = HERE / "limits" / f"{cell_name}.json"
    return load_json(own if own.exists() else HERE / "limits" / f"{kind}.json")


def metrics_of(cell_name: str, bench: dict, group: str) -> list[dict]:
    """The `group` ("end_to_end" or "per_layer") metrics that this cell
    reports: those whose `workloads` lists it, or that have none."""
    return [m for m in bench[group] if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str):
    """The read(ctx) function of metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
