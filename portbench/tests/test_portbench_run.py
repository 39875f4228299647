"""A run's contract on the CPU, at a small size: the result's line, the
check against the reference, and a check that fails the timed path's
faults and the control."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import control, harness, spec
from portbench.spec import ROOT
from portbench.tests.conftest import SMALL, bench_for

SEED = 2**31 + 12345  # larger than 32 signed bits hold


def run(cell, seconds=0.5, trace=False, device="cpu"):
    return harness.run_cell(cell, SEED, seconds, trace, device=device, bench=bench_for(cell))


def test_result_line(small_traffic):
    result, lines = run("orbit800.file20k")
    line = json.dumps(result)
    back = json.loads(line)
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(back)[-1] == "checks"
    assert back["correct"] is True and back["attempted"] >= 1 and back["failed"] == 0
    assert set(back["metrics"]) == {"frame_ms", "frame_ms_p95", "peak_mem_gib", "setup_s"}
    for m in back["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    assert set(back["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert [ln.split(":")[0] for ln in lines] == [f"check {k}" for k in back["checks"]]
    for k, v in back["checks"].items():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]


@pytest.mark.parametrize("cell", ["orbit800.file20k", "orbit800.forest131k", "train800.test20k",
                                  "orbit800.mis.file20k"])
def test_program_matches_reference(small_traffic, cell):
    result, _ = run(cell)
    assert result["correct"], result["checks"]


def _state_unchanged(monkeypatch):
    from tpuray_torch.render import renderer
    step = renderer.Renderer.step

    def stale(self, camera):
        old = self.state
        out = step(self, camera)
        self.state = old
        return out
    monkeypatch.setattr(renderer.Renderer, "step", stale)


def _half_the_rays(monkeypatch):
    from tpuray_torch.render import renderer
    trace_paths = renderer.trace_paths

    def half(*a, **k):
        pt = trace_paths(*a, **k)
        n = pt.color.shape[0]
        return pt._replace(color=torch.cat([pt.color[: n // 2], torch.zeros_like(pt.color[n // 2:])]))
    monkeypatch.setattr(renderer, "trace_paths", half)


def _answer_altered(monkeypatch):
    from tpuray_torch.render import renderer
    step = renderer.Renderer.step

    def altered(self, camera):
        out = step(self, camera)
        final = out.final.clone()
        final[:4, :4] += 0.25
        return out._replace(final=final)
    monkeypatch.setattr(renderer.Renderer, "step", altered)


@pytest.mark.parametrize("cell, fault", [
    ("orbit800.file20k", _state_unchanged), ("orbit800.file20k", _half_the_rays),
    ("orbit800.file20k", _answer_altered), ("orbit800.mis.file20k", _half_the_rays)],
    ids=["fault0", "fault1", "fault2", "mis-half_the_rays"])
def test_frame_faults_fail(small_traffic, monkeypatch, cell, fault):
    fault(monkeypatch)
    result, _ = run(cell)
    assert not result["correct"], result["checks"]


def _buffers_reused(monkeypatch):
    """Not a fault: the program writes each frame's state and outputs into
    the same buffers (as a replayed CUDA graph does)."""
    import dataclasses

    from tpuray_torch.render import renderer
    step = renderer.Renderer.step
    static: dict = {}

    def into(key, t):
        if key not in static:
            static[key] = t.clone()
        return static[key].copy_(t)

    def in_place(self, camera):
        old = self.state
        out = step(self, camera)
        for f in dataclasses.fields(old):
            v = getattr(self.state, f.name)
            if isinstance(v, torch.Tensor):
                getattr(old, f.name).copy_(v)
            else:
                setattr(old, f.name, v)
        self.state = old
        return out._replace(
            svgf=out.svgf._replace(**{k: into(("svgf", k), v)
                                      for k, v in out.svgf._asdict().items()}),
            gbuffer=out.gbuffer._replace(**{k: into(("gbuffer", k), v)
                                            for k, v in out.gbuffer._asdict().items()}),
            **{k: into(k, getattr(out, k)) for k in ("pt_color", "accum_color", "final")})
    monkeypatch.setattr(renderer.Renderer, "step", in_place)


def test_reused_buffers_stay_correct(small_traffic, monkeypatch):
    _buffers_reused(monkeypatch)
    result, _ = run("orbit800.file20k")
    assert result["correct"], result["checks"]


def _optimizer_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_the_batch(monkeypatch):
    from tpuray_torch.train import optimize
    render_flat = optimize.render_flat

    def half(*a, **k):
        img = render_flat(*a, **k)
        return img.reshape(-1, 3)[::2].repeat_interleave(2, 0).reshape(img.shape)
    monkeypatch.setattr(optimize, "render_flat", half)


@pytest.mark.parametrize("fault", [_optimizer_unchanged, _half_the_batch])
def test_train_faults_fail(small_traffic, monkeypatch, fault):
    fault(monkeypatch)
    result, _ = run("train800.test20k")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [_optimizer_unchanged, _half_the_batch])
def test_window_step_faults_fail(small_traffic, monkeypatch, fault):
    """A fault that begins after the warm-up is caught by the step kept
    from the window, while the warm-up's numbers pass."""
    from portbench import clients
    warm_up = clients.Train.warm_up

    def then_fault(self):
        warm_up(self)
        fault(monkeypatch)
    monkeypatch.setattr(clients.Train, "warm_up", then_fault)
    result, _ = run("train800.test20k")
    checks = result["checks"]
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in ("loss", "grad", "change"))
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", ["orbit800.file20k", "train800.test20k", "orbit800.mis.file20k"])
def test_control_fails(small_traffic, cell):
    b = bench_for(cell)
    r = control.readings(cell, SEED, 0.3, device="cpu", traffic_override=SMALL, bench=b)
    lim = spec.limits(cell, spec.traffic(spec.cell(cell, b)["traffic"])["kind"])
    ok = all(r["control"][k] <= v for k, v in lim["limits"].items())
    assert not ok, r["control"]
    assert all(r["program"][k] <= v for k, v in lim["limits"].items()), r["program"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "orbit800.file20k", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_fails(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "orbit800.file20k", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0
    assert not out.stdout.strip().endswith("}")


def test_card_run_traced(card):
    result, _ = run("orbit800.file20k", seconds=2.0, trace=True, device=card)
    assert result["correct"]
    assert result["device"]["busy_s"] > 0 and result["device"]["window_s"] > 0
    assert len(result["breakdown"]["device_ops"]) <= 10
    names = {m["name"] for m in spec.metrics_of("orbit800.file20k", spec.benchmark(), "per_layer")}
    assert names == set(result["metrics"])
