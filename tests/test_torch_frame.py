"""The port end to end: tpuray_torch's integrator and Renderer vs tpuray's
on the CPU (device="cpu"), without compaction, with SVGF off (slice 1) and
on (slice 2, the default view).

- trace_paths on 1,024 rays: the tolerances of
  tests/test_pallas_kernel.py:test_fused_secondary_matches_separate_integrator
  (color rtol 2e-4 / atol 2e-5, first-hit validity exact, albedo rtol 1e-5),
  on all but 1% of the rays. XLA on the CPU contracts multiply-adds into
  FMAs (the triangle constants, n.d, o + d*t), the port does not (nor do
  its CUDA kernels), so hit distances differ by an ulp; a glossy lobe's pdf
  and a grazing shadow test can turn that into a visible change on a few
  rays in a thousand.
- two moving-camera Renderer frames at 48x48: pt_color and final with the
  image tolerance of tests/test_dist_frame.py (all but 0.5% of pixels within
  5e-4, none beyond 0.1: a one-ulp shift can flip a grazing shadow test),
  first-hit validity and coverage exact, G-buffer linear_z within rtol 1e-5.
- SVGF and TAA on: 3 moving frames and 1 still frame at 48x48 (the still
  one takes the static-camera branch on both sides): final, the modulated
  image and the history tap with the same image tolerance, the displayed
  image within atol 2e-3.
- a fresh interpreter with jax blocked imports tpuray_torch and renders
  with SVGF on.
- slice 3 (SVGF + TAA on, 2 moving frames at 32x32, the image tolerance
  above): a chunked forest (make_large_scene at the size of
  tests/test_partition.py, every walk through K6's plain version) and the
  separate-walk NEE integrator (fused_secondary=False: K1 for the
  primaries, K3 for every other walk); and which traversal entry each
  frame calls, and how often (the launch counts chip_smoke.py checks on the
  card). The MIS integrator is tests/test_torch_mis.py.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tpuray
from tpuray.integrator import path_tracer as jpt
from tpuray.scene.camera import OrbitCamera as JOrbitCamera
from tpuray.scene.config import RenderConfig as JRenderConfig
import tpuray.scene.partition as jpart
from tpuray.accel.bvh import build_bvh
from tpuray.scene.procedural import make_large_scene, make_test_scene

import tpuray_torch
from tpuray_torch.integrator import path_tracer
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.render.renderer import render_frame
from tpuray_torch.scene.procedural import make_large_scene_arrays
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.types import scene_from_numpy, scene_to_numpy

from tests.test_torch_native import port_numpy_builders

torch.set_num_threads(2)

SLICE = dict(enable_svgf=False, compact_frac=0.0, compact_auto=False)
SVGF_SLICE = dict(compact_frac=0.0, compact_auto=False)  # the default view
H = W = 48


def assert_images_close(a, b, tol=5e-4, outlier_frac=0.005,
                        outlier_max=0.1, msg=""):
    d = np.abs(np.asarray(a) - np.asarray(b)).max(-1)
    frac = float((d > tol).mean())
    assert frac <= outlier_frac, f"{msg}: {frac:.4%} pixels differ > {tol}"
    assert d.max() < outlier_max, f"{msg}: max diff {d.max():.4f}"


@pytest.fixture(scope="module")
def scenes():
    js = make_test_scene(subdiv=2, env_width=32)
    return js, scene_from_numpy(scene_to_numpy(js))


@pytest.mark.parametrize("extra", [
    {}, {"tile_coherent_sampling": True}, {"enable_aniso": True}],
    ids=["default", "tile_coherent", "aniso"])
def test_trace_paths_matches(scenes, extra):
    js, ts = scenes
    n = 1024
    rng = np.random.default_rng(21)
    o = np.tile(np.asarray([[0.0, 0.3, 2.0]], np.float32), (n, 1))
    o += (rng.random((n, 3)).astype(np.float32) - 0.5) * 0.4
    tgt = (rng.random((n, 3)).astype(np.float32) - 0.5) * 1.5
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    px = np.arange(n, dtype=np.uint32)
    py = np.arange(n, dtype=np.uint32) * np.uint32(3)
    cfg = dict(max_tracing_depth=2, compact_frac=0.0, compact_auto=False, **extra)

    ref = jpt.trace_paths(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(px),
                          jnp.asarray(py), jnp.uint32(5), JRenderConfig(**cfg))
    out = path_tracer.trace_paths(
        ts, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(px.astype(np.int64)),
        torch.from_numpy(py.astype(np.int64)), 5, RenderConfig(**cfg))
    off = ~np.isclose(out.color.numpy(), np.asarray(ref.color),
                      rtol=2e-4, atol=2e-5).all(-1)
    assert off.mean() <= 0.01, f"{off.sum()} of {n} rays beyond rtol 2e-4"
    np.testing.assert_array_equal(out.first_hit_valid.numpy(),
                                  np.asarray(ref.first_hit_valid))
    np.testing.assert_allclose(out.albedo.numpy(), np.asarray(ref.albedo),
                               rtol=1e-5, atol=1e-7)
    assert np.asarray(ref.first_hit_valid).mean() > 0.3
    assert np.asarray(ref.color).max() > 0.05


def test_renderer_moving_frames_match(scenes):
    js, ts = scenes
    jr = tpuray.Renderer(js, JRenderConfig(width=W, height=H, **SLICE))
    tr = tpuray_torch.Renderer(ts, RenderConfig(width=W, height=H, **SLICE),
                               device="cpu")
    jcam, tcam = JOrbitCamera(width=W, height=H), OrbitCamera(width=W, height=H)
    for frame in range(2):
        jo = jr.step(jcam.snapshot())
        to = tr.step(tcam.snapshot())
        msg = f"frame {frame}"
        assert_images_close(to.pt_color.numpy(), jo.pt_color, msg=msg)
        assert_images_close(to.final.numpy(), jo.final, msg=msg)
        assert torch.equal(to.final, to.pt_color)
        jz = np.asarray(jo.gbuffer.linear_z)
        tz = to.gbuffer.linear_z.numpy()
        np.testing.assert_array_equal(tz != 1.0, jz != 1.0, err_msg=msg)
        np.testing.assert_allclose(tz, jz, rtol=1e-5, err_msg=msg)
        assert float(to.coverage) == float(jo.coverage)
        assert 0.2 < float(to.coverage) < 1.0
        jcam.rotate(0.5, 0.0)
        tcam.rotate(0.5, 0.0)
    assert tr.state.frame_idx == 2
    img = tr.display_image()
    np.testing.assert_allclose(img, jr.display_image(), atol=2e-3)


@pytest.fixture(scope="module")
def svgf_frames(scenes):
    """3 moving frames, then 1 with the camera still, on both Renderers."""
    js, ts = scenes
    jr = tpuray.Renderer(js, JRenderConfig(width=W, height=H, **SVGF_SLICE))
    tr = tpuray_torch.Renderer(ts, RenderConfig(width=W, height=H, **SVGF_SLICE),
                               device="cpu")
    jcam, tcam = JOrbitCamera(width=W, height=H), OrbitCamera(width=W, height=H)
    frames = []
    for frame in range(4):
        if frame < 3:
            jcam.rotate(0.5, 0.0)
            tcam.rotate(0.5, 0.0)
        jo, to = jr.step(jcam.snapshot()), tr.step(tcam.snapshot())
        frames.append((jo, to, jr.display_image(), tr.display_image()))
    return frames


@pytest.mark.parametrize("frame", [0, 1, 2, 3], ids=["moving0", "moving1",
                                                     "moving2", "still"])
def test_renderer_svgf_frames_match(svgf_frames, frame):
    jo, to, jimg, timg = svgf_frames[frame]
    msg = f"frame {frame}"
    assert_images_close(to.final.numpy(), jo.final, msg=msg + " final")
    assert_images_close(to.svgf.modulated.numpy(), jo.svgf.modulated,
                        msg=msg + " modulated")
    assert_images_close(to.svgf.history_tap.numpy(), jo.svgf.history_tap,
                        msg=msg + " history_tap")
    np.testing.assert_allclose(timg, jimg, atol=2e-3, err_msg=msg)
    assert not torch.equal(to.final, to.pt_color)  # the denoiser ran
    hl = to.svgf.history_len
    assert float(hl.max()) == min(frame + 1, 32)  # history grows


def test_renderer_needs_cuda_unless_asked_for_cpu(scenes, monkeypatch):
    _, ts = scenes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RenderConfig(width=16, height=16, **SVGF_SLICE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpuray_torch.Renderer(ts, cfg)
    assert tpuray_torch.Renderer(ts, cfg, device="cpu").device.type == "cpu"


def test_still_camera_is_off_the_card_only():
    """An unchanged view after frame 0 takes the static-camera branch off
    the card only, as tpuray takes it only off its own device; on the card
    a still camera runs K4 with zero motion."""
    from tpuray_torch.render.renderer import still_camera
    vp = np.eye(4, dtype=np.float32)
    assert still_camera(torch.device("cpu"), 1, vp, vp.copy())
    assert not still_camera(torch.device("cpu"), 0, vp, vp.copy())
    assert not still_camera(torch.device("cpu"), 1, vp, 2 * vp)
    assert not still_camera(torch.device("cuda"), 1, vp, vp.copy())


@pytest.mark.parametrize("field,value,item", [
    ("reproject_gather", "tiled", "TPU-only"),
    ("fast_reproject", True, "TPU-only"),
])
def test_unported_config_raises(scenes, field, value, item):
    _, ts = scenes
    cfg = RenderConfig(width=16, height=16, **dict(SVGF_SLICE, **{field: value}))
    with pytest.raises(NotImplementedError, match=item):
        tpuray_torch.Renderer(ts, cfg, device="cpu")


@pytest.mark.parametrize("field,value", [
    ("compact_frac", 0.5), ("compact_auto", True), ("use_normal_map", True)])
def test_ported_config_renders(scenes, field, value):
    """The options that raised until compaction and textures were ported:
    a frame renders, finite (a scene without textures ignores the normal
    map)."""
    _, ts = scenes
    cfg = RenderConfig(width=16, height=16, **dict(SVGF_SLICE, **{field: value}))
    out = tpuray_torch.Renderer(ts, cfg, device="cpu").step(
        OrbitCamera(width=16, height=16).snapshot())
    assert bool(torch.isfinite(out.final).all())


def test_renders_without_jax():
    """The card's machine has no jax: the package must not need it."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["tpuray"] = None
import torch
torch.set_num_threads(2)
from tpuray_torch import Renderer, RenderConfig
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.procedural import make_test_scene
cfg = RenderConfig(width=16, height=16, compact_frac=0.0, compact_auto=False)
r = Renderer(make_test_scene(subdiv=1, env_width=32), cfg, device="cpu")
cam = OrbitCamera(width=16, height=16)
for _ in range(2):
    out = r.step(cam.snapshot())
    cam.rotate(0.5, 0.0)
assert torch.isfinite(out.final).all() and out.final.shape == (16, 16, 3)
assert not torch.equal(out.final, out.pt_color)
assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items() if v}
print("ok", float(out.coverage))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


LARGE = dict(n_spheres=6, subdiv=2, max_chunk_tris=512, env_width=32)
H3 = W3 = 32


@pytest.fixture(scope="module")
def large_scenes():
    """make_large_scene in both packages, both with the numpy BVH builder
    forced (the two native libraries' builds differ: the JAX package's is
    built with -march=native)."""
    orig = jpart.build_bvh
    jpart.build_bvh = lambda tv, leaf=8, force_py=False: build_bvh(
        tv, leaf, force_py=True)
    try:
        js = make_large_scene(**LARGE)
    finally:
        jpart.build_bvh = orig
    with port_numpy_builders():
        return js, scene_from_numpy(make_large_scene_arrays(**LARGE))


@pytest.mark.parametrize("case", ["forest", "separate_walk"])
def test_renderer_slice3_frames_match(scenes, large_scenes, case):
    js, ts = large_scenes if case == "forest" else scenes
    extra = {} if case == "forest" else {"fused_secondary": False}
    kw = dict(width=W3, height=H3, **SVGF_SLICE, **extra)
    jr = tpuray.Renderer(js, JRenderConfig(**kw))
    tr = tpuray_torch.Renderer(ts, RenderConfig(**kw), device="cpu")
    assert bool(tr.tables.chunk_nodes) == (case == "forest")
    jcam = JOrbitCamera(width=W3, height=H3, radius=4.0)
    tcam = OrbitCamera(width=W3, height=H3, radius=4.0)
    for frame in range(2):
        jo, to = jr.step(jcam.snapshot()), tr.step(tcam.snapshot())
        msg = f"{case} frame {frame}"
        assert_images_close(to.pt_color.numpy(), jo.pt_color, msg=msg + " pt")
        assert_images_close(to.final.numpy(), jo.final, msg=msg + " final")
        jz = np.asarray(jo.gbuffer.linear_z)
        tz = to.gbuffer.linear_z.numpy()
        np.testing.assert_array_equal(tz != 1.0, jz != 1.0, err_msg=msg)
        np.testing.assert_allclose(tz, jz, rtol=1e-5, err_msg=msg)
        assert float(to.coverage) == float(jo.coverage)
        assert 0.2 < float(to.coverage) < 1.0
        jcam.rotate(0.5, 0.0)
        tcam.rotate(0.5, 0.0)


@pytest.mark.parametrize("case,want", [
    ("forest", dict(packets=0, batched=0, multi=0, chunked=6)),
    ("separate_walk", dict(packets=1, batched=5, multi=0, chunked=0)),
    ("mis", dict(packets=1, batched=5, multi=0, chunked=0)),
    ("fused", dict(packets=1, batched=0, multi=2, chunked=0)),
])
def test_frame_trace_routes(scenes, large_scenes, case, want):
    """Which traversal entry a depth-2 frame calls and how often: on the
    card each call is one launch of K1 (packets), K3 (batched), K2 (multi)
    or K6 (chunked)."""
    ts = large_scenes[1] if case == "forest" else scenes[1]
    extra = {"separate_walk": {"fused_secondary": False},
             "mis": {"integrator": "mis"}}.get(case, {})
    cfg = RenderConfig(width=16, height=16, **SVGF_SLICE, **extra)
    calls = dict.fromkeys(want, 0)

    def counting(name):
        fn = getattr(path_tracer.PLAIN, name)

        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    tracer = path_tracer.Tracer(**{name: counting(name) for name in want})
    cam = OrbitCamera(width=16, height=16, radius=4.0).snapshot()
    _, out = render_frame(ts, cam, FrameState.initial(16, 16), cfg, 16, 16,
                          tracer=tracer, tables=path_tracer.pack_traversal(ts))
    assert calls == want
    assert bool(torch.isfinite(out.final).all())
