"""The port's viewer (tpuray_torch/viewer/) and the Renderer's config
assignment on the CPU, against tpuray.

- The counterparts of tests/test_viewer.py over loopback HTTP, on a server
  started with device="cpu" at 32x32, depth 1, 2 a-trous iterations and
  max_fps 10 (the render thread shares the CPU with the other test
  workers): the page and /state, the long poll, a parameter event
  resetting accumulation, camera events, the view switch and the PNG
  round trip.
- The page is tpuray's byte for byte. One event list through both
  packages' _apply_events, on servers that were not started: the same
  camera, config, view and state_json bytes.
- A parameter event reaches the next frame's config, with compact_auto on
  (in the compaction bucket the Renderer chose) and off. tpuray renders
  the next frame with the new config only with compact_auto off; with it
  on, its _frame_cfg keeps the old parameters (ROADMAP.md section 3):
  pinned here. The frame's config is read from a render_frame that
  records it and stops the step, so no frame is traced.
- A fault on the render thread is raised by check(), by the long poll and
  as a 500 from /frame.png, not swallowed. A POSTed event that could not
  be applied (a value that does not convert, a missing key, a parameter
  outside its slider's range) is answered 400 and never reaches the render
  thread, which goes on rendering.
"""
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import tpuray.render.renderer as jrenderer
from tpuray.io.image import read_png as jread_png
from tpuray.scene.camera import OrbitCamera as JOrbitCamera
from tpuray.scene.config import RenderConfig as JRenderConfig
from tpuray.scene.procedural import make_test_scene as jmake_test_scene
from tpuray.viewer import server as jserver
from tpuray.viewer import ui as jui

import tpuray_torch.render.renderer as trenderer
from tpuray_torch.io.image import encode_png, read_png
from tpuray_torch.render.renderer import Renderer
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import DebugView, RenderConfig
from tpuray_torch.scene.procedural import make_test_scene
from tpuray_torch.viewer import server as tserver
from tpuray_torch.viewer import ui

torch.set_num_threads(2)

CFG = dict(width=32, height=32, max_tracing_depth=1, num_atrous_iterations=2)


@pytest.fixture(scope="module")
def server():
    s = tserver.ViewerServer(make_test_scene(subdiv=1, env_width=32), RenderConfig(**CFG),
                             port=0, max_fps=10.0, device="cpu")
    s.start()
    yield s
    s.stop()
    s.check()


def _get(server, path):
    # the long poll replies 204 when no frame lands within its window
    for _ in range(8):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}{path}", timeout=60) as r:
            if r.status == 204 and path.startswith("/frame.png"):
                continue
            return r.status, dict(r.headers), r.read()
    raise TimeoutError(f"no frame from {path} after 8 long-poll windows")


def _frames(server, n):
    """Wait for n frames newer than the newest one now."""
    seq = int(_get(server, "/frame.png?seq=-1")[1]["X-Seq"])
    for _ in range(n):
        seq = int(_get(server, f"/frame.png?seq={seq}")[1]["X-Seq"])
    return seq


def test_page_and_state(server):
    code, _, body = _get(server, "/")
    assert code == 200 and b"tpuray" in body and b"max_tracing_depth" in body
    assert body == ui.render_page().encode() == jui.render_page().encode()
    code, _, body = _get(server, "/state")
    state = json.loads(body)
    assert state["params"]["max_tracing_depth"] == 1
    assert state["width"] == 32 and state["view"] == int(DebugView.FINAL)


def test_frame_long_poll(server):
    code, headers, body = _get(server, "/frame.png?seq=-1")
    assert code == 200
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    seq = int(headers["X-Seq"])
    stats = json.loads(headers["X-Stats"])
    assert stats["frame"] >= 1 and stats["ms"] > 0
    code2, headers2, body2 = _get(server, f"/frame.png?seq={seq}")
    assert code2 == 200 and int(headers2["X-Seq"]) > seq
    img = np.frombuffer(body2, np.uint8)
    assert img.size > 0


def test_control_resets_accumulation(server):
    _get(server, "/frame.png?seq=-1")
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/control",
        data=json.dumps({"type": "param", "name": "sigma_l", "value": 2.5}).encode(),
        method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        assert json.loads(r.read())["ok"]
    _frames(server, 3)
    assert server.renderer.cfg.sigma_l == 2.5
    assert server.renderer.frame_cfg.sigma_l == 2.5
    code, _, body = _get(server, "/state")
    assert json.loads(body)["params"]["sigma_l"] == 2.5


def test_camera_events(server):
    yaw0 = server.camera.yaw_deg
    server.submit({"type": "rotate", "dx": 5.0, "dy": 0.0})
    server.submit({"type": "dolly", "d": 0.1})
    server.submit({"type": "pan", "forward": 0.05, "right": 0.0})
    _frames(server, 3)
    assert server.camera.yaw_deg == pytest.approx(yaw0 + 5.0)


def test_view_switch(server):
    server.submit({"type": "view", "view": int(DebugView.SVGF_VARIANCE)})
    _frames(server, 2)
    assert server.view == DebugView.SVGF_VARIANCE
    server.submit({"type": "view", "view": int(DebugView.FINAL)})


def test_bad_control_and_paths(server):
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}/control",
                                 data=b"{not json", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{server.port}/nope", timeout=60)
    assert e.value.code == 404


@pytest.mark.parametrize("ev", [
    {"type": "param", "name": "num_atrous_iterations", "value": "x"},
    {"type": "param", "name": "sigma_l"},
    {"type": "param", "name": "num_atrous_iterations", "value": 0},
    {"type": "param", "name": "max_tracing_depth", "value": 64},
    {"type": "rotate", "dy": 1.0},
    {"type": "dolly", "d": "nan"},
    {"type": "view", "view": "svgf"},
    [1, 2],
], ids=["value", "no-value", "below-range", "above-range", "no-dx", "nan", "view",
        "not-an-object"])
def test_bad_event_is_refused(server, ev):
    """The POST answers 400; the config stays and the next frames render."""
    cfg = server.renderer.cfg
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}/control",
                                 data=json.dumps(ev).encode(), method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400 and not json.loads(e.value.read())["ok"]
    _frames(server, 2)
    server.check()
    assert server.renderer.cfg == cfg


def test_png_encode_decode_roundtrip(tmp_path):
    img = np.random.default_rng(3).random((17, 23, 3)).astype(np.float32)
    p = tmp_path / "x.png"
    p.write_bytes(encode_png(img, compress_level=1))
    back = read_png(str(p))
    q = np.clip(img * 255 + 0.5, 0, 255).astype(np.uint8) / 255.0
    assert np.abs(back - q).max() < 1e-6
    np.testing.assert_array_equal(back, jread_png(str(p)))


EVENTS = [
    {"type": "rotate", "dx": 12.5, "dy": -4.0},
    {"type": "dolly", "d": 0.3},
    {"type": "pan", "forward": 0.05, "right": -0.1},
    {"type": "pan", "right": 0.2},
    {"type": "param", "name": "num_atrous_iterations", "value": 3.0},
    {"type": "param", "name": "sigma_l", "value": "2.5"},
    {"type": "param", "name": "accumulate", "value": False},
    {"type": "param", "name": "width", "value": 64},  # not a UI parameter
    {"type": "view", "view": int(DebugView.SVGF_ATROUS)},
    {"type": "view", "view": 99},  # no such view: ignored
    {"type": "reset"},
    {"type": "unknown"},
]


def test_events_match_tpuray():
    ours = tserver.ViewerServer(make_test_scene(subdiv=0, env_width=16),
                                RenderConfig(**CFG), port=0, device="cpu")
    ref = jserver.ViewerServer(jmake_test_scene(subdiv=0, env_width=16),
                               JRenderConfig(**CFG), port=0)
    assert ours.state_json() == ref.state_json()
    for ev in EVENTS:  # ours as POST passes them on
        ours.submit(tserver.parse_event(ev))
        ref.submit(ev)
    for s in (ours, ref):
        s._apply_events()
    assert ours.state_json() == ref.state_json()
    assert dataclasses.asdict(ours.renderer.cfg) == dataclasses.asdict(ref.renderer.cfg)
    assert ours.view == ref.view == DebugView.SVGF_ATROUS
    for k in ("yaw_deg", "pitch_deg", "radius"):
        assert getattr(ours.camera, k) == getattr(ref.camera, k), k
    np.testing.assert_array_equal(ours.camera.snapshot().view_proj.numpy(),
                                  np.asarray(ref.camera.snapshot().view_proj))
    assert ours.renderer.state.frame_idx == int(ref.renderer.state.frame_idx) == 0


class _Stop(Exception):
    pass


def _next_frame_cfg(monkeypatch, module, r, camera):
    """The config that r.step hands render_frame (recorded, then the step
    stops before any tracing). Only this thread's call is recorded: the
    module's server fixture renders on its own thread meanwhile, and its
    calls go to the real render_frame."""
    seen, me, real = [], threading.get_ident(), module.render_frame

    def record(scene, cam, state, cfg, *a, **k):
        if threading.get_ident() != me:
            return real(scene, cam, state, cfg, *a, **k)
        seen.append(cfg)
        raise _Stop

    monkeypatch.setattr(module, "render_frame", record)
    with pytest.raises(_Stop):
        r.step(camera)
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("auto", [True, False], ids=["compact_auto", "fixed"])
def test_param_reaches_next_frame(monkeypatch, auto):
    """Through the viewer: a param event, then the next frame's config.
    With compact_auto the Renderer first moves to a bucket (16 frames: the
    coverage read a period late), which the new config keeps."""
    cfg = RenderConfig(**CFG, compact_auto=auto)
    s = tserver.ViewerServer(make_test_scene(subdiv=1, env_width=32), cfg, port=0,
                             device="cpu")
    for _ in range(16 if auto else 1):
        s.render_once()
    bucket = s.renderer.frame_cfg.compact_frac
    assert (bucket != cfg.compact_frac) == auto
    s.submit({"type": "param", "name": "num_atrous_iterations", "value": 3})
    s.submit({"type": "param", "name": "sigma_l", "value": 1.5})
    s._apply_events()
    got = _next_frame_cfg(monkeypatch, trenderer, s.renderer, s.camera.snapshot())
    assert got == s.renderer.cfg.replace(compact_frac=bucket)
    assert (got.num_atrous_iterations, got.sigma_l) == (3, 1.5)
    assert s.renderer.state.frame_idx == 0
    png, stats = s.render_once()
    assert stats["frame"] == 1 and "atrous=3" in stats["text"]


@pytest.mark.parametrize("auto", [True, False], ids=["compact_auto", "fixed"])
def test_renderer_cfg_assignment(monkeypatch, auto):
    """Renderer.cfg = ... reaches the next step; the setter checks the
    config and resolves enable_aniso="auto" as the constructor does."""
    r = Renderer(make_test_scene(subdiv=0, env_width=16),
                 RenderConfig(**CFG, compact_auto=auto), device="cpu")
    cam = OrbitCamera(width=32, height=32).snapshot()
    r.cfg = r.cfg.replace(sigma_n=64.0, enable_aniso="auto")
    got = _next_frame_cfg(monkeypatch, trenderer, r, cam)
    assert got.sigma_n == 64.0 and got.enable_aniso is False
    assert got == r.frame_cfg == r.cfg
    with pytest.raises(NotImplementedError):
        r.cfg = r.cfg.replace(reproject_gather="tiled")


@pytest.mark.parametrize("auto", [True, False], ids=["compact_auto", "fixed"])
def test_tpuray_frame_cfg(monkeypatch, auto):
    """tpuray's Renderer: with compact_auto off the next frame takes the new
    config; with it on, its _frame_cfg keeps the old one until the bucket
    next changes (the divergence the port does not copy)."""
    cfg = JRenderConfig(**CFG, compact_auto=auto)
    r = jrenderer.Renderer(jmake_test_scene(subdiv=0, env_width=16), cfg)
    r.cfg = r.cfg.replace(num_atrous_iterations=3)
    got = _next_frame_cfg(monkeypatch, jrenderer, r,
                          JOrbitCamera(width=32, height=32).snapshot())
    assert got.num_atrous_iterations == (2 if auto else 3)


def test_render_thread_fault_is_raised(monkeypatch):
    s = tserver.ViewerServer(make_test_scene(subdiv=0, env_width=16), RenderConfig(**CFG),
                             port=0, max_fps=10.0, device="cpu")

    def fault(camera):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(s.renderer, "step", fault)
    s.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{s.port}/frame.png?seq=-1", timeout=60)
        assert e.value.code == 500 and b"illegal memory access" in e.value.read()
        with pytest.raises(RuntimeError, match="render thread failed"):
            s.wait_frame(-1)
    finally:
        s.stop()
    with pytest.raises(RuntimeError) as e:
        s.check()
    assert "illegal memory access" in str(e.value.__cause__)
    assert not any(th.is_alive() for th in s._threads)
