"""The MIS integrator (integrator/mis.py) and the env-map sampling it
adds, against tpuray on the CPU, through K1's and K3's plain versions.

Tolerances:
- mis_mix_weight exact up to rtol 1e-6 (one multiply-add);
- sample_env against the JAX package's quad-packed version (which the
  integrator calls) and its plain one within rtol 1e-5 / atol 1e-6 (trig
  rounds differently under XLA on the CPU); env_pdf within rtol 1e-4 (as
  tests/test_torch_sampling.py) and 5e-3 where |d.y| > 0.99: near a pole
  asin(d.y) turns an ulp of trig into 1e-4 of the texel coordinate, which
  the 1/cos(elevation) Jacobian scales;
- trace_paths on 4,096 rays (one tile_coherent_sampling block): the
  tolerances of tests/test_torch_frame.py:test_trace_paths_matches (color
  rtol 2e-4 / atol 2e-5 on all but 1% of the rays, first-hit validity
  exact, albedo rtol 1e-5), with and without tile_coherent_sampling;
- two moving-camera Renderer frames at 32x32 with SVGF + TAA on, with the
  image tolerance of tests/test_dist_frame.py (all but 0.5% of pixels
  within 5e-4, none beyond 0.1).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tpuray
from tpuray.integrator import gather_tables as jgt
from tpuray.integrator import mis as jmis
from tpuray.integrator import path_tracer as jpt
from tpuray.sampling import envmap as jenv
from tpuray.scene.camera import OrbitCamera as JOrbitCamera
from tpuray.scene.config import RenderConfig as JRenderConfig
from tpuray.scene.procedural import make_test_scene

import tpuray_torch
from tpuray_torch.integrator import mis, path_tracer
from tpuray_torch.sampling import envmap as env
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.types import scene_from_numpy, scene_to_numpy

torch.set_num_threads(2)

MIS = dict(integrator="mis", compact_frac=0.0, compact_auto=False)


def assert_images_close(a, b, tol=5e-4, outlier_frac=0.005, outlier_max=0.1,
                        msg=""):
    d = np.abs(np.asarray(a) - np.asarray(b)).max(-1)
    frac = float((d > tol).mean())
    assert frac <= outlier_frac, f"{msg}: {frac:.4%} pixels differ > {tol}"
    assert d.max() < outlier_max, f"{msg}: max diff {d.max():.4f}"


@pytest.fixture(scope="module")
def scenes():
    js = make_test_scene(subdiv=2, env_width=32)
    return js, scene_from_numpy(scene_to_numpy(js))


def test_mis_mix_weight_matches():
    rng = np.random.default_rng(1)
    a = (rng.random(512) * 10).astype(np.float32)
    b = (rng.random(512) * 10).astype(np.float32)
    a[:8] = 0.0
    b[:4] = 0.0
    got = mis.mis_mix_weight(torch.from_numpy(a), torch.from_numpy(b))
    want = jmis.mis_mix_weight(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_sample_env_and_pdf_match(scenes):
    js, ts = scenes
    rng = np.random.default_rng(2)
    xi = rng.random((2, 4096)).astype(np.float32)
    xi[:, :4] = [[0.0, 0.999999, 0.5, 1e-7], [0.999999, 0.0, 1e-7, 0.5]]
    cache_q = jgt.quad_pack_image(js.envmap.cache)
    want = jenv.sample_env_packed(cache_q, jnp.asarray(xi[0]), jnp.asarray(xi[1]))
    got = env.sample_env(ts.envmap.cache, *torch.from_numpy(xi))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jenv.sample_env(js.envmap.cache, xi[0], xi[1])),
        rtol=1e-5, atol=1e-6)
    d = np.array(want)
    pdf = env.env_pdf(ts.envmap.cache, torch.from_numpy(d)).numpy()
    want_pdf = np.asarray(jenv.env_pdf_packed(cache_q, jnp.asarray(d)))
    pole = np.abs(d[:, 1]) > 0.99
    np.testing.assert_allclose(pdf[~pole], want_pdf[~pole], rtol=1e-4)
    np.testing.assert_allclose(pdf[pole], want_pdf[pole], rtol=5e-3)
    assert pdf.min() > 0.0 and pole.mean() < 0.05


@pytest.mark.parametrize("coherent", [False, True],
                         ids=["per_pixel", "tile_coherent"])
def test_trace_paths_mis_matches(scenes, coherent):
    js, ts = scenes
    n = mis.PACKET  # one tile_coherent_sampling block
    rng = np.random.default_rng(22)
    o = np.tile(np.asarray([[0.0, 0.3, 2.0]], np.float32), (n, 1))
    tgt = (rng.random((n, 3)).astype(np.float32) - 0.5) * 1.5
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    px = np.arange(n, dtype=np.uint32) % 64
    py = np.arange(n, dtype=np.uint32) // 64
    cfg = dict(max_tracing_depth=2, tile_coherent_sampling=coherent, **MIS)
    ref = jpt.trace_paths(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(px),
                          jnp.asarray(py), jnp.uint32(3), JRenderConfig(**cfg),
                          common_origin=True)
    out = path_tracer.trace_paths(
        ts, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(px.astype(np.int64)),
        torch.from_numpy(py.astype(np.int64)), 3, RenderConfig(**cfg),
        common_origin=True)
    off = ~np.isclose(out.color.numpy(), np.asarray(ref.color),
                      rtol=2e-4, atol=2e-5).all(-1)
    assert off.mean() <= 0.01, f"{off.sum()} of {n} rays beyond rtol 2e-4"
    np.testing.assert_array_equal(out.first_hit_valid.numpy(),
                                  np.asarray(ref.first_hit_valid))
    np.testing.assert_allclose(out.albedo.numpy(), np.asarray(ref.albedo),
                               rtol=1e-5, atol=1e-7)
    assert 0.3 < np.asarray(ref.first_hit_valid).mean() < 1.0
    assert np.asarray(ref.color).max() > 0.05


def test_renderer_mis_frames_match(scenes):
    js, ts = scenes
    h = w = 32
    jr = tpuray.Renderer(js, JRenderConfig(width=w, height=h, **MIS))
    tr = tpuray_torch.Renderer(ts, RenderConfig(width=w, height=h, **MIS),
                               device="cpu")
    jcam, tcam = JOrbitCamera(width=w, height=h), OrbitCamera(width=w, height=h)
    for frame in range(2):
        jo, to = jr.step(jcam.snapshot()), tr.step(tcam.snapshot())
        msg = f"MIS frame {frame}"
        assert_images_close(to.pt_color.numpy(), jo.pt_color, msg=msg + " pt")
        assert_images_close(to.final.numpy(), jo.final, msg=msg + " final")
        np.testing.assert_array_equal(to.gbuffer.linear_z.numpy() != 1.0,
                                      np.asarray(jo.gbuffer.linear_z) != 1.0)
        assert float(to.coverage) == float(jo.coverage)
        assert not torch.equal(to.final, to.pt_color)
        jcam.rotate(0.5, 0.0)
        tcam.rotate(0.5, 0.0)
