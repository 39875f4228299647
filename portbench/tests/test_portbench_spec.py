"""BENCHMARK.json against the contract it is written to, and every file
of every cell found by name."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import clients, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


HELD = sorted(p.stem for p in (spec.HERE / "held").glob("*.json"))


def bench_of(held: str | None) -> dict:
    b = spec.benchmark()
    return spec.with_held(b, held) if held else b


@pytest.mark.parametrize("held", [None] + HELD)
def test_benchmark_json_contract(held):
    """BENCHMARK.json, and BENCHMARK.json with a held cell's entries back."""
    b = bench_of(held)
    assert set(b) == TOP
    assert b["command"] == ["python3", "-m", "portbench.run"]
    assert b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["name"] in {w["config"] for w in b["workloads"]}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["reduced"] == spec.config(c["name"])["reduced"]
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    # a quarter of the cells, rounded down, may take four chips; one always may
    four = [w["name"] for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4), four
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        reported = [m["name"] for m in spec.metrics_of(cell, b, "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_of(cell, b, "per_layer")
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]] + HELD)
def test_files_found_by_name(cell):
    b = bench_of(cell if cell in HELD else None)
    w = spec.cell(cell, b)
    conf, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    assert conf["name"] == w["config"]
    assert traffic["kind"] in clients.CLIENTS
    assert traffic.get("ranks", 1) == w["chips"]  # a rank a chip
    lim = spec.limits(cell, traffic["kind"])
    assert lim["limits"]
    for m in spec.metrics_of(cell, b, "per_layer"):
        assert callable(spec.reader(m["name"]))


def test_adding_a_cell_is_only_files(tmp_path, monkeypatch):
    """A new cell, traffic mix, configuration and per-layer metric are new
    files under portbench/ and new entries in BENCHMARK.json."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = spec.benchmark()
    (root / "portbench" / "traffic" / "orbit400.json").write_text(json.dumps(
        dict(spec.traffic("orbit800"), width=400, height=400)))
    (root / "portbench" / "configs" / "file5k.json").write_text(json.dumps(
        dict(spec.config("file20k"), name="file5k",
             scene=dict(spec.config("file20k")["scene"], subdiv=4))))
    (root / "portbench" / "metrics" / "units_traced.py").write_text(
        "def read(ctx):\n    return ctx.units\n")
    b["configs"].append(dict(b["configs"][0], name="file5k", file="portbench/configs/file5k.json"))
    b["workloads"].append(dict(name="orbit400.file5k", config="file5k", traffic="orbit400",
                               chips=1, why="a new cell"))
    b["per_layer"].append(dict(name="units_traced", unit="frames", better="higher",
                               source="device_trace", layer="device (one H100)",
                               moves="setup_s", workloads=["orbit400.file5k"]))
    for m in b["end_to_end"]:
        if m["name"] in ("frame_ms", "frame_ms_p95", "peak_mem_gib"):
            m["workloads"].append("orbit400.file5k")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(spec, "HERE", root / "portbench")
    monkeypatch.setattr(spec, "ROOT", root)
    nb = spec.benchmark(root)
    w = spec.cell("orbit400.file5k", nb)
    assert spec.config(w["config"])["scene"]["subdiv"] == 4
    assert spec.traffic(w["traffic"])["width"] == 400
    assert spec.limits(w["name"], "orbit")["limits"]
    per_layer = [m["name"] for m in spec.metrics_of(w["name"], nb, "per_layer")]
    assert "units_traced" in per_layer
    assert spec.reader("units_traced")(type("C", (), {"units": 7})) == 7
