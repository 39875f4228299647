"""The port's spans and frame counters (tpuray_torch/utils/metrics.py) on
the CPU, and the benchmark's readers of them (portbench/spans.py,
portbench/metrics/).

- A Renderer frame under torch.profiler with compaction on holds
  tpuray.frame > tpuray.trace_paths > tpuray.wait.hit_count and
  tpuray.frame > tpuray.svgf > tpuray.taa, each an ordinary CPU op (no
  user annotation, which the profiler would also emit as a device event);
  the lagged coverage read is tpuray.wait.coverage; the sharded frame is
  a tpuray.frame too.
- With no profiler a span is the one shared null context, no frame record
  is kept, and a frame's outputs are bit-equal with and without one.
- A frame record's lanes, shaded_lanes and residual follow
  _compact_budget, for a frame whose hits fit the budget and one that
  needs the residual pass, and for an uncompacted frame.
- Each of the eight readers gives its known value on a hand-built trace
  and records: an idle gap straddles the end of one span and the start of
  the next, a frame without a wait span reads 0.0, and a trace without
  the program's spans (a program that has none) reads None.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, spec
from portbench.traceread import Trace
from tpuray_torch.dist.frame import render_frame_sharded, shard_state
from tpuray_torch.dist.sharding import make_mesh
from tpuray_torch.integrator.path_tracer import _compact_budget
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.render.renderer import LaggedScalar, Renderer
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.procedural import make_test_scene
from tpuray_torch.utils import metrics
from tpuray_torch.utils.checkpoint import tree_leaves

torch.set_num_threads(2)

SIZE = 16
# camera -> primary hits of the 1,024 lanes (16x16 padded to a 32x32 tile):
# 288 fit the 0.5 budget's 512 lanes, 742 overflow it
FITS = dict(radius=3.0, pitch_deg=-10.0)
OVERFLOWS = dict(radius=2.0, pitch_deg=10.0)


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(subdiv=0, env_width=16)


def _camera(**kw):
    return OrbitCamera(width=SIZE, height=SIZE, **kw).snapshot()


def _cfg(frac):
    return RenderConfig(width=SIZE, height=SIZE, compact_frac=frac, compact_auto=False)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith("tpuray.")]


def _inside(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.fixture(scope="module")
def frame_spans(scene):
    """The spans of one profiled Renderer frame that runs host_count."""
    r = Renderer(scene, _cfg(0.5), device="cpu")
    prof, _ = _profiled(lambda: r.step(_camera(**FITS)))
    return _spans(prof)


def test_frame_spans_nest(frame_spans):
    by = {}
    for e in frame_spans:
        by.setdefault(e.name, []).append(e)
    assert {k: len(v) for k, v in by.items()} == {
        "tpuray.frame": 1, "tpuray.trace_paths": 1, "tpuray.wait.hit_count": 1,
        "tpuray.svgf": 1, "tpuray.taa": 1}
    (frame,), (tp,), (wait,) = (by[k] for k in (
        "tpuray.frame", "tpuray.trace_paths", "tpuray.wait.hit_count"))
    (svgf,), (taa,) = by["tpuray.svgf"], by["tpuray.taa"]
    assert _inside(tp, frame) and _inside(wait, tp)
    assert _inside(svgf, frame) and _inside(taa, svgf)
    assert tp.time_range.end <= svgf.time_range.start


def test_spans_are_cpu_ops(frame_spans):
    for e in frame_spans:
        assert not e.is_user_annotation, e.name
        assert e.device_type == torch.autograd.DeviceType.CPU, e.name


def test_lagged_read_is_a_wait_span():
    lagged = LaggedScalar(torch.tensor(0.25))
    prof, value = _profiled(lagged.read)
    assert value == 0.25
    assert [e.name for e in _spans(prof)] == ["tpuray.wait.coverage"]


def test_sharded_frame_is_a_frame(scene):
    mesh = make_mesh("cpu")
    cfg = dataclasses.replace(_cfg(0.0), num_atrous_iterations=2)
    state = shard_state(FrameState.initial(SIZE, SIZE), mesh)
    before = len(metrics.frame_records())
    with torch.no_grad():
        prof, _ = _profiled(lambda: render_frame_sharded(
            scene, _camera(), state, cfg, SIZE, SIZE, mesh, halo=8))
    names = [e.name for e in _spans(prof)]
    assert names.count("tpuray.frame") == 1 and "tpuray.trace_paths" in names
    rec = metrics.frame_records()[-1]
    assert len(metrics.frame_records()) == before + 1
    assert rec["lanes"] == rec["shaded_lanes"] == SIZE * SIZE and rec["coverage"] is None


def test_span_off_is_the_null_context():
    assert not torch.autograd._profiler_enabled()
    assert metrics.span("tpuray.frame") is metrics.span("tpuray.taa")
    before = metrics.frame_records()
    with metrics.span("tpuray.frame"):
        metrics.count("lanes", 7)
    assert metrics.frame_records() == before


def test_unprofiled_frame_keeps_no_record_and_matches(scene):
    cfg = _cfg(0.5)
    plain, traced = Renderer(scene, cfg, device="cpu"), Renderer(scene, cfg, device="cpu")
    cams = [_camera(radius=2.0, pitch_deg=10.0 + i) for i in range(2)]
    for cam in cams:
        before = len(metrics.frame_records())
        a = plain.step(cam)
        assert len(metrics.frame_records()) == before
        _, b = _profiled(lambda: traced.step(cam))
        assert len(metrics.frame_records()) == before + 1
        for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
            assert torch.equal(x, y)
    for f in dataclasses.fields(plain.state):
        x, y = getattr(plain.state, f.name), getattr(traced.state, f.name)
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, f.name


@pytest.mark.parametrize("frac,camera", [(0.5, FITS), (0.5, OVERFLOWS), (0.0, FITS)],
                         ids=["fits", "residual", "uncompacted"])
def test_frame_record_follows_budget(scene, frac, camera):
    cfg = _cfg(frac)
    r = Renderer(scene, cfg, device="cpu")
    _, out = _profiled(lambda: r.step(_camera(**camera)))
    rec = metrics.frame_records()[-1]
    n = 32 * 32
    budget = _compact_budget(n, cfg)
    hits = round(float(out.coverage) * n)
    assert rec["lanes"] == n and rec["frame_idx"] == 0
    assert rec["coverage"] == float(out.coverage)
    if frac == 0.0:
        assert budget == 0 and rec["shaded_lanes"] == n and not rec["residual"]
    else:
        assert budget == 512 and rec["residual"] == (hits > budget)
        assert rec["residual"] == (camera is OVERFLOWS)
        assert rec["shaded_lanes"] == budget + (n if rec["residual"] else 0)


def test_records_are_bounded():
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(metrics.RECORDS + 5):
            with metrics.span(metrics.FRAME):
                metrics.count("frame_idx", i)
    recs = metrics.frame_records()
    assert len(recs) == metrics.RECORDS == 1024
    assert recs[-1]["frame_idx"] == metrics.RECORDS + 4 and recs[0]["frame_idx"] == 5


# --- the readers, on a hand-built trace (us) ---------------------------------
# frame 1 [0, 100]: trace_paths [10, 50] holding the hit-count wait [20, 30],
# svgf [55, 95] holding taa [80, 90]; frame 2 [200, 300]: trace_paths
# [210, 240] (no wait), svgf [250, 290] holding taa [270, 285], the
# coverage wait [292, 296]. Device busy: [0, 40], [58, 70], [85, 120],
# [205, 215], [245, 275], [290, 295]; the idle gap [40, 58] straddles
# trace_paths' end (40-50) and svgf's start (55-58).
HOST = [("tpuray.frame", 0, 100), ("tpuray.trace_paths", 10, 50),
        ("tpuray.wait.hit_count", 20, 30), ("aten::mul", 12, 14),
        ("tpuray.svgf", 55, 95), ("tpuray.taa", 80, 90),
        ("tpuray.frame", 200, 300), ("tpuray.trace_paths", 210, 240),
        ("tpuray.svgf", 250, 290), ("tpuray.taa", 270, 285),
        ("tpuray.wait.coverage", 292, 296), ("cudaLaunchKernel", 150, 160)]
DEVICE = [("k", 0, 15), ("k", 12, 40), ("k", 58, 70), ("k", 85, 120),
          ("k", 205, 215), ("k", 245, 275), ("k", 290, 295)]
# self (us): trace_paths [10, 20] + [30, 50] + [210, 240] = 60, idle 10 + 25;
# svgf [55, 80] + [90, 95] + [250, 270] + [285, 290] = 55, idle 3 + 10 + 5;
# taa [80, 90] + [270, 285] = 25, idle 5 + 10; waits 10 + 4. Two frames.
WANT = {"trace_paths_host_ms.frame": 0.030, "trace_paths_idle_ms.frame": 0.0175,
        "svgf_host_ms.frame": 0.0275, "svgf_idle_ms.frame": 0.009,
        "taa_host_ms.frame": 0.0125, "taa_idle_ms.frame": 0.0075,
        "host_wait_ms.frame": 0.007}
RECORDS = [dict(frame_idx=0, lanes=1024, shaded_lanes=1024, residual=False, coverage=0.9),
           dict(frame_idx=1, lanes=1024, shaded_lanes=512, residual=False, coverage=0.25),
           dict(frame_idx=2, lanes=1024, shaded_lanes=1536, residual=True, coverage=0.75)]
NEW = [m["name"] for m in spec.benchmark()["per_layer"] if m["name"] in WANT] + [
    "shade_lane_use.frame"]


def _ctx(host=HOST, device=DEVICE, units=2, unit="frame"):
    return harness.Ctx(unit=unit, units=units, unit_wall_s=1e-3, trace=Trace(device, host),
                       counts=[], iterations=5, scene_build_s=0.0)


@pytest.fixture
def records(monkeypatch):
    monkeypatch.setattr(metrics, "frame_records", lambda: list(RECORDS))


def test_eight_readers_in_the_benchmark():
    assert len(NEW) == 8
    for m in spec.benchmark()["per_layer"]:
        if m["name"] in NEW:
            assert m["moves"] == "frame_ms"
            assert m["workloads"] == [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("name", NEW)
def test_reader_known_value(records, name):
    # the last two records: (0.25 + 0.75) x 1024 hits over 512 + 1536 lanes
    want = WANT.get(name, 50.0)
    assert spec.reader(name)(_ctx()) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", NEW)
def test_reader_other_unit_is_none(records, name):
    assert spec.reader(name)(_ctx(unit="step")) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_spans_is_none(name):
    host = [op for op in HOST if not op[0].startswith("tpuray.")]
    assert spec.reader(name)(_ctx(host=host)) is None


def test_frame_without_a_wait_reads_zero():
    host = [op for op in HOST if op[1] >= 200 and not op[0].startswith("tpuray.wait.")]
    ctx = _ctx(host=host, units=1)
    assert spec.reader("host_wait_ms.frame")(ctx) == 0.0
    assert spec.reader("trace_paths_host_ms.frame")(ctx) == pytest.approx(0.030)


def test_idle_outside_the_spans():
    """The three layers' idle ms sum to no more than the trace's idle time
    a frame; here the rest is the frames' own time (40-50 trace_paths, 50-55
    the frame, ...) and the time between frames."""
    ctx = _ctx()
    layers = sum(spec.reader(f"{k}_idle_ms.frame")(ctx) for k in ("trace_paths", "svgf", "taa"))
    idle_ms = (300 - ctx.trace.busy_us()) / 1e3 / ctx.units
    assert layers == pytest.approx(0.034) and layers <= idle_ms


def test_shade_lane_use_without_records_is_none(monkeypatch):
    monkeypatch.setattr(metrics, "frame_records", lambda: [])
    assert spec.reader("shade_lane_use.frame")(_ctx()) is None
    monkeypatch.setattr(metrics, "frame_records", lambda: [dict(RECORDS[0], coverage=None)])
    assert spec.reader("shade_lane_use.frame")(_ctx()) is None


def test_shade_lane_use_on_a_program_without_records(monkeypatch):
    monkeypatch.delattr(metrics, "frame_records")
    assert spec.reader("shade_lane_use.frame")(_ctx()) is None
