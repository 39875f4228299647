"""Bounce compaction in the port (integrator/path_tracer.py:select_hits,
shade_selected, render/renderer.py's budget buckets) against tpuray on the CPU.

The compacted loop shades the lanes whose primary ray hit, packed densely;
every sample stream is keyed on pixel, never on lane, so a pixel gets the
same math as in the uncompacted loop. Tolerances are tpuray's own
(tests/test_compaction.py): color, emission, albedo and the first hit
within rtol 2e-4 / atol 2e-5, first-hit validity and t exact, against the
port's uncompacted trace_paths. Against tpuray's compacted trace_paths the
same tolerance holds on all but 0.5% of the rays (the frame tests'
allowance, tests/test_torch_frame.py: XLA on the CPU contracts
multiply-adds, which moves hit points by an ulp). Gradients through the
compacted path equal the uncompacted ones within rtol 1e-3, as in
tests/test_compaction.py.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tpuray.integrator import path_tracer as jpt
from tpuray.render.renderer import Renderer as JRenderer
from tpuray.scene.camera import OrbitCamera as JOrbitCamera
from tpuray.scene.config import RenderConfig as JRenderConfig
from tpuray.scene.procedural import make_test_scene

from tpuray_torch.integrator import path_tracer
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.render.renderer import Renderer, render_frame
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.types import scene_from_numpy, scene_to_numpy

torch.set_num_threads(2)

SIZE = 48
RTOL, ATOL = 2e-4, 2e-5
OUTLIERS = 0.005


@pytest.fixture(scope="module")
def scenes():
    js = make_test_scene(subdiv=2, env_width=32)
    return js, scene_from_numpy(scene_to_numpy(js))


def _rays(size):
    """Row-major primaries of tests/test_compaction.py:_rays, in numpy."""
    cam = JOrbitCamera(width=size, height=size).snapshot()
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    xx, yy = xx.reshape(-1), yy.reshape(-1)
    th = np.float32(cam.tan_half_fov)
    xs = ((2.0 * (xx + 0.5) / size - 1.0) * th).astype(np.float32)
    ys = (-(2.0 * (yy + 0.5) / size - 1.0) * th).astype(np.float32)
    d = np.stack([xs, ys, -np.ones_like(xs)], axis=-1)
    d = (d @ np.asarray(cam.cam_to_world).T).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.asarray(cam.eye, np.float32)[None], (size * size, 1))
    return o, d, xx, yy


@pytest.fixture(scope="module")
def rays():
    return _rays(SIZE)


def _port(ts, rays, frac, **extra):
    o, d, px, py = rays
    cfg = RenderConfig(width=SIZE, height=SIZE, max_tracing_depth=2,
                       compact_frac=frac, **extra)
    return path_tracer.trace_paths(
        ts, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(px.astype(np.int64)),
        torch.from_numpy(py.astype(np.int64)), 3, cfg, common_origin=True)


def _jax(js, rays, frac, **extra):
    o, d, px, py = rays
    cfg = JRenderConfig(width=SIZE, height=SIZE, max_tracing_depth=2,
                        compact_frac=frac, **extra)
    return jax.jit(lambda: jpt.trace_paths(
        js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(px.astype(np.uint32)),
        jnp.asarray(py.astype(np.uint32)), jnp.uint32(3), cfg,
        common_origin=True))()


@pytest.mark.parametrize("n,frac,extra", [
    (4096, 0.5, {}), (640000, 0.5, {}), (4096, 0.0, {}),
    (4096, 0.5, {"tile_coherent_sampling": True}), (300, 0.5, {}),
    (2304, 0.24, {}), (640000, 0.125, {}), (640000, 0.25, {}), (511, 0.999, {}),
], ids=["half", "full_frame", "off", "coherent", "degenerate", "overflow_case",
        "bucket_eighth", "bucket_quarter", "at_n"])
def test_compact_budget_matches(n, frac, extra):
    """tests/test_compaction.py:test_budget_rounding, case for case, and the
    budgets the frames below use."""
    got = path_tracer._compact_budget(n, RenderConfig(compact_frac=frac, **extra))
    assert got == jpt._compact_budget(n, JRenderConfig(compact_frac=frac, **extra))
    assert got % 512 == 0 and (got == 0 or got < n)
    want = {(4096, 0.5): 2048, (4096, 0.0): 0, (300, 0.5): 0, (2304, 0.24): 1024}
    if (n, frac) in want:
        assert got == want[(n, frac)]


def _assert_close(out, ref, exact_t=True):
    for f in ("color", "emission", "albedo"):
        np.testing.assert_allclose(getattr(out, f).numpy(), getattr(ref, f).numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    np.testing.assert_array_equal(out.first_hit_valid.numpy(),
                                  ref.first_hit_valid.numpy())
    if exact_t:
        np.testing.assert_array_equal(out.first_hit_t.numpy(), ref.first_hit_t.numpy())
    v = ref.first_hit_valid.numpy()
    for f in ("first_hit_point", "first_hit_normal"):
        np.testing.assert_allclose(getattr(out, f).numpy()[v], getattr(ref, f).numpy()[v],
                                   rtol=RTOL, atol=ATOL, err_msg=f)


@pytest.mark.parametrize("frac,overflows", [(0.5, False), (0.24, True)],
                         ids=["fits", "residual"])
def test_compacted_matches_uncompacted(scenes, rays, frac, overflows):
    """The port compacted vs the port uncompacted, at a budget that holds
    every hit and at one that overflows (the residual pass)."""
    _, ts = scenes
    n_hit = int(_port(ts, rays, 0.0).first_hit_valid.sum())
    budget = path_tracer._compact_budget(SIZE * SIZE, RenderConfig(compact_frac=frac))
    assert (n_hit > budget) == overflows
    _assert_close(_port(ts, rays, frac), _port(ts, rays, 0.0))


@pytest.mark.parametrize("frac", [0.5, 0.24], ids=["fits", "residual"])
def test_compacted_matches_tpuray(scenes, rays, frac):
    js, ts = scenes
    out, ref = _port(ts, rays, frac), _jax(js, rays, frac)
    off = ~np.isclose(out.color.numpy(), np.asarray(ref.color),
                      rtol=RTOL, atol=ATOL).all(-1)
    assert off.mean() <= OUTLIERS, f"{off.sum()} of {off.size} rays beyond rtol {RTOL}"
    np.testing.assert_array_equal(out.first_hit_valid.numpy(),
                                  np.asarray(ref.first_hit_valid))
    np.testing.assert_allclose(out.albedo.numpy(), np.asarray(ref.albedo),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(out.emission.numpy(), np.asarray(ref.emission),
                               rtol=1e-5, atol=1e-7)


def test_coherent_sampling_survives_compaction(scenes, rays):
    """tile_coherent_sampling keys on px // 32, never on the lane: compacted
    and uncompacted agree, and the tile stream differs from the per-pixel
    one (tests/test_compaction.py:95)."""
    _, ts = scenes
    com = _port(ts, rays, 0.5, tile_coherent_sampling=True)
    _assert_close(com, _port(ts, rays, 0.0, tile_coherent_sampling=True))
    per_pixel = _port(ts, rays, 0.5)
    assert float((per_pixel.color - com.color).abs().max()) > 1e-4


def test_mis_ignores_compaction(scenes, rays):
    """The MIS integrator returns before compaction, as in tpuray."""
    _, ts = scenes
    a = _port(ts, rays, 0.5, integrator="mis")
    b = _port(ts, rays, 0.0, integrator="mis")
    assert torch.equal(a.color, b.color)


@pytest.mark.parametrize("frac", [0.75, 0.5], ids=["fits", "residual"])
def test_gradients_match(scenes, frac):
    """d(mean color)/d(base-color scale) through render_frame, SVGF off,
    depth 1: compacted as uncompacted (tests/test_compaction.py). 550 of the
    1,024 primaries hit: a budget of 768 holds them, one of 512 does not."""
    _, ts = scenes
    size = 32
    cam = OrbitCamera(width=size, height=size).snapshot()

    def grad(f):
        s = torch.tensor(0.7, requires_grad=True)
        cfg = RenderConfig(width=size, height=size, max_tracing_depth=1,
                           compact_frac=f, enable_svgf=False)
        sc = ts.replace(materials=ts.materials.replace(
            base_color=torch.abs(ts.materials.base_color) * s))
        _, out = render_frame(sc, cam, FrameState.initial(size, size), cfg, size, size)
        torch.mean(out.pt_color).backward()
        return float(s.grad)

    g0, g1 = grad(0.0), grad(frac)
    assert np.isfinite(g0) and abs(g0) > 0
    np.testing.assert_allclose(g1, g0, rtol=1e-3)


class _Out:
    def __init__(self, coverage):
        self.coverage = coverage


# hit coverage per frame: steady, a zoom-in, a zoom-out, and frames that
# need no compaction; each bucket switch is read a period (8 frames) late
COVERAGE = ([0.05] * 16 + [0.15] * 8 + [0.3] * 8 + [0.6] * 8 + [0.09] * 16
            + [0.0] * 8)


def test_bucket_chooser_matches_tpuray(scenes):
    """The Renderer's compact_frac per frame on a scripted coverage
    sequence, against tpuray's Renderer._tune_compaction."""
    js, ts = scenes
    r = Renderer(ts, RenderConfig(width=16, height=16), device="cpu")
    jr = JRenderer(js, JRenderConfig(width=16, height=16))
    got, want = [], []
    for cov in COVERAGE:
        got.append(r.frame_cfg.compact_frac)
        want.append(jr._frame_cfg.compact_frac)
        r._tune_compaction(_Out(torch.tensor(cov)))
        jr._tune_compaction(_Out(jnp.float32(cov)))
    assert got == want
    # 0.5 until the first read (after frame 16), then one period behind
    assert got[:16] == [0.5] * 16 and got[16] == 0.125
    assert {0.125, 0.25, 0.5, 0.0} <= set(got)
    assert r.frame_cfg.compact_frac == jr._frame_cfg.compact_frac


def test_default_renderer_frames(scenes):
    """RenderConfig() as it is (compact_frac 0.5, compact_auto): the
    Renderer's frames equal the same frames at the bucket it chose, rendered
    uncompacted, within the image tolerance of tests/test_torch_frame.py."""
    _, ts = scenes
    size = 32
    r = Renderer(ts, RenderConfig(width=size, height=size), device="cpu")
    ref = Renderer(ts, RenderConfig(width=size, height=size, compact_frac=0.0,
                                    compact_auto=False), device="cpu")
    cam = OrbitCamera(width=size, height=size)
    for _ in range(3):
        cam.rotate(0.5, 0.0)
        out, out0 = r.step(cam.snapshot()), ref.step(cam.snapshot())
        d = (out.final - out0.final).abs().amax(-1)
        assert float((d > 5e-4).float().mean()) <= 0.005
        assert float(d.max()) < 0.1
        assert torch.equal(out.svgf.history_len, out0.svgf.history_len)
