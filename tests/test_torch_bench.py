"""The port's benchmark (tpuray_torch/bench.py) against bench.py on the CPU.

Each piece is held against bench.py's own lines on the same inputs:
- the camera primaries equal bench.py:95-105's numpy (tpuray's
  tile_pixel_coords_np and OrbitCamera), bit for bit at 128x128 and
  800x800;
- the incoherent rays: bench.py:183-198's function, copied here verbatim
  and run under jax.jit, on seeded origins, directions and hit distances
  (some misses) at bench.py's 640,000 rays: the hashed uint32 values (also
  on random 32-bit inputs) and u1, u2 exactly, p and the directions within
  atol 1e-6 (XLA's cos and sin may round an ulp apart);
- the six gradient checks' losses as one function of six scales, every
  scale applied at once (bench.py:364-427), so that JAX compiles a single
  value_and_grad: render_frame at 16x16, depth 2, SVGF off, compaction on;
  the loss within rtol 1e-5 of tpuray's, the six gradients within rtol 5e-4
  (measured: 4.4e-7 on the loss; 1.6e-6 to 8.3e-5 on the gradients, the
  largest light_pos_interior's). tpuray's Disney samplers take the port's
  sin-from-cos, made in-process as tests/test_torch_train.py does;
- the SVGF chain's inputs have bench.py:266-286's shapes, dtypes and
  ranges (the values are torch's generator's, not jax.random's);
- `--device cpu` prints one stdout line with bench.py's CPU keys, and
  without a CUDA device the bench raises before printing anything.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuray.integrator import disney as jdisney
from tpuray.render.frame_state import FrameState as JFrameState
from tpuray.render.renderer import render_frame as jrender_frame
from tpuray.render.tiling import tile_pixel_coords_np
from tpuray.scene.camera import OrbitCamera as JOrbitCamera
from tpuray.scene.config import RenderConfig as JRenderConfig
from tpuray.scene.procedural import make_test_scene

from tpuray_torch import bench
from tpuray_torch.cli import main as cli
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.render.renderer import render_frame
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.types import scene_from_numpy, scene_to_numpy
from tests.test_torch_train import _guarded_gtr1, _guarded_gtr2

torch.set_num_threads(2)

N_RAYS = 640_000  # bench.py's 800x800 primaries
GRAD = 16
SCALES = [x0 for _, x0, _, _ in bench.GRADCHECKS]
NAMES = [name for name, *_ in bench.GRADCHECKS]


def _bench_py_primaries(width, height):
    """bench.py:91-105, verbatim but for the names."""
    cam = JOrbitCamera(width=width, height=height).snapshot()
    xx, yy = tile_pixel_coords_np(height, width)
    n_rays = int(xx.shape[0])
    xs = ((2.0 * (xx.astype(np.float32) + 0.5) / width - 1.0)
          * float(cam.tan_half_fov))
    ys = (-(2.0 * (yy.astype(np.float32) + 0.5) / height - 1.0)
          * float(cam.tan_half_fov))
    d_cam = np.stack([xs, ys, -np.ones_like(xs)], axis=-1)
    d_np = d_cam @ np.asarray(cam.cam_to_world, np.float32).T
    d_np /= np.linalg.norm(d_np, axis=-1, keepdims=True)
    o_np = np.broadcast_to(np.asarray(cam.eye, np.float32), (n_rays, 3))
    return o_np, d_np


@pytest.mark.parametrize("size", [128, 800])
def test_primaries_match_bench_py(size):
    o, d = bench.primary_rays(OrbitCamera(width=size, height=size).snapshot(), size, size)
    o_ref, d_ref = _bench_py_primaries(size, size)
    assert d.dtype == np.float32 and d.shape == d_ref.shape == (size * size, 3)
    np.testing.assert_array_equal(o, o_ref)
    np.testing.assert_array_equal(d, d_ref)


def _h(x):
    """bench.py:186-191, verbatim."""
    x = (x ^ jnp.uint32(61)) ^ (x >> 16)
    x = x * jnp.uint32(9)
    x = x ^ (x >> 4)
    x = x * jnp.uint32(0x27d4eb2d)
    return (x ^ (x >> 15)).astype(jnp.uint32)


def _jax_incoherent(n_rays):
    """bench.py:182-198, verbatim (h is _h above)."""
    @jax.jit
    def incoherent_inputs(o, d, t):
        p = o + d * jnp.minimum(t, 10.0)[..., None]
        i = jnp.arange(n_rays, dtype=jnp.uint32)
        h = _h
        u1 = h(i).astype(jnp.float32) / np.float32(2**32)
        u2 = h(i * jnp.uint32(7919)).astype(jnp.float32) / np.float32(2**32)
        ct = 1.0 - 2.0 * u1
        st = jnp.sqrt(jnp.maximum(0.0, 1.0 - ct * ct))
        phi = 2.0 * np.pi * u2
        dirs = jnp.stack([st * jnp.cos(phi), ct, st * jnp.sin(phi)], -1)
        return p, dirs
    return incoherent_inputs


def test_hash_is_bit_exact():
    rng = np.random.default_rng(3)
    x = np.concatenate([np.arange(N_RAYS, dtype=np.uint32),
                        np.arange(N_RAYS, dtype=np.uint32) * np.uint32(7919),
                        rng.integers(0, 2**32, 200_000, dtype=np.uint32),
                        np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)])
    want = np.asarray(jax.jit(_h)(jnp.asarray(x)))
    got = bench.hash_u32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    i = jnp.arange(N_RAYS, dtype=jnp.uint32)
    u1, u2 = bench.hash_uniforms(N_RAYS, "cpu")
    np.testing.assert_array_equal(
        u1.numpy(), np.asarray(_h(i).astype(jnp.float32) / np.float32(2**32)))
    np.testing.assert_array_equal(
        u2.numpy(), np.asarray(_h(i * jnp.uint32(7919)).astype(jnp.float32)
                               / np.float32(2**32)))


def test_incoherent_inputs_match_bench_py():
    rng = np.random.default_rng(4)
    o = np.broadcast_to(rng.standard_normal(3).astype(np.float32), (N_RAYS, 3))
    d = rng.standard_normal((N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = (rng.random(N_RAYS) * 20).astype(np.float32)
    t[rng.random(N_RAYS) < 0.3] = bench.INF  # misses
    p_ref, dirs_ref = _jax_incoherent(N_RAYS)(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t))
    p, dirs = bench.incoherent_inputs(torch.from_numpy(np.ascontiguousarray(o)),
                                      torch.from_numpy(d), torch.from_numpy(t))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dirs.numpy(), np.asarray(dirs_ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(dirs.numpy(), axis=-1), 1.0, atol=1e-6)


@pytest.fixture(scope="module")
def grad_scene():
    js = make_test_scene(subdiv=3)
    return js, scene_from_numpy(scene_to_numpy(js))


def _jax_loss_and_grad(js):
    """bench.py:364-427's six losses with every scale applied at once."""
    cam = JOrbitCamera(width=GRAD, height=GRAD).snapshot()
    st0 = JFrameState.initial(GRAD, GRAD)
    cfg = JRenderConfig(width=GRAD, height=GRAD, max_tracing_depth=2, enable_svgf=False)

    def loss(s):
        m, lights = js.materials, js.lights
        lp = lights.position
        mats = m.replace(base_color=jnp.abs(m.base_color) * s[0],
                         specular=jnp.full_like(m.specular, 0.5) * s[1],
                         sheen=jnp.full_like(m.sheen, 0.5) * s[2],
                         roughness=jnp.clip(jnp.abs(m.roughness) * s[5], 0.05, 1.0))
        lights = lights.replace(
            radiance=lights.radiance * s[3],
            position=lp + jnp.stack([jnp.full(lp.shape[:1], s[4]), jnp.zeros(lp.shape[:1]),
                                     jnp.zeros(lp.shape[:1])], axis=-1))
        _, out = jrender_frame(js.replace(materials=mats, lights=lights), cam, st0, cfg,
                               GRAD, GRAD)
        return jnp.mean(out.pt_color)

    orig = jdisney.sample_gtr1, jdisney.sample_gtr2
    jdisney.sample_gtr1, jdisney.sample_gtr2 = _guarded_gtr1, _guarded_gtr2
    try:
        value, grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(SCALES, jnp.float32))
    finally:
        jdisney.sample_gtr1, jdisney.sample_gtr2 = orig
    return float(value), np.asarray(grad)


def test_gradcheck_losses_match_tpuray(grad_scene):
    js, ts = grad_scene
    assert NAMES == ["base_color", "specular", "sheen", "light_radiance",
                     "light_pos_interior", "roughness_d2"]
    want_loss, want_grad = _jax_loss_and_grad(js)
    s = torch.tensor(SCALES, requires_grad=True)
    cfg = bench.gradcheck_config(GRAD)
    assert (cfg.max_tracing_depth, cfg.enable_svgf, cfg.compact_frac) == (2, False, 0.5)
    _, out = render_frame(bench.scaled_scene(ts, {n: s[k] for k, n in enumerate(NAMES)}),
                          OrbitCamera(width=GRAD, height=GRAD).snapshot(),
                          FrameState.initial(GRAD, GRAD), cfg, GRAD, GRAD)
    loss = out.pt_color.mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    assert np.all(np.abs(want_grad) > 1e-6), want_grad
    np.testing.assert_allclose(s.grad.numpy(), want_grad, rtol=5e-4, atol=0)


def test_svgf_inputs_have_bench_py_ranges():
    h, w = 1080, 1920
    gbuf, st, color, emi, alb = bench.svgf_inputs(h, w, "cpu")
    fields = {"normal": (gbuf.normal, 3, -1, 1), "linear_z": (gbuf.linear_z, None, 0, 0.9),
              "velocity": (gbuf.velocity, 2, -0.005, 0.005),
              "fwidth_normal": (gbuf.fwidth_normal, None, 0, 0.1),
              "fwidth_z": (gbuf.fwidth_z, None, 0, 0.01),
              "world_pos": (gbuf.world_pos, 3, -2, 2),
              "illum_hist": (st.illum_hist, 3, 0, 1),
              "variance_hist": (st.variance_hist, None, 0, 0.1),
              "moments": (st.moments, 2, 0, 1), "color": (color, 3, 0, 1),
              "emission": (emi, 3, 0, 0.05), "albedo": (alb, 3, 0.2, 1.2)}
    for name, (x, c, lo, hi) in fields.items():
        assert x.shape == ((h, w) if c is None else (h, w, c)), name
        assert x.dtype == torch.float32, name
        assert lo <= float(x.min()) and float(x.max()) <= hi, name
        assert float(x.max()) - float(x.min()) > 0.9 * (hi - lo), name
    np.testing.assert_allclose(torch.linalg.vector_norm(gbuf.normal, dim=-1).numpy(), 1.0,
                               atol=1e-5)
    assert st.prev_normal is gbuf.normal and st.prev_linear_z is gbuf.linear_z
    assert bool((st.history_len == 8.0).all()) and st.frame_idx == 8
    again = bench.svgf_inputs(h, w, "cpu")
    assert torch.equal(again[2], color) and torch.equal(again[0].velocity, gbuf.velocity)


def test_cpu_bench_prints_the_headline(capsys):
    assert bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "trace_rays_per_second" and line["value"] > 0
    assert cli.main(["bench", "--device", "cpu"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 1


def test_bench_without_cuda_raises(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench"])
    assert capsys.readouterr() == ("", "")
