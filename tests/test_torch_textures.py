"""Textures and normal maps in the port (integrator/gather_tables.py,
integrator/path_tracer.py:resolve_hit) against tpuray on the CPU.

- pack_texture_stack: the same bf16 bits as tpuray's (compared as uint16),
  on float layers (which round) and on 8-bit layers (exact);
- tex_fetch_packed and the f32 normal-layer fetch: within atol 1e-6 of
  tpuray's tex_fetch_packed and _tex_fetch;
- resolve_hit on a textured scene from build_scene, with and without the
  normal map: point, shading normal and every material field within atol
  1e-6 (XLA on the CPU contracts multiply-adds; a few ulps);
- one Renderer frame of that scene under RenderConfig(width=64, height=64),
  every other option at its default (compaction on, SVGF and TAA on),
  against tpuray's render_frame: pt_color and final with the image
  tolerance of tests/test_torch_frame.py, coverage and first-hit validity
  exact.
"""
import contextlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tpuray.accel.bvh as jbvh
import tpuray.io.native as jnative
import tpuray.scene.builder as jbuilder
import tpuray.scene.partition as jpart
from tpuray.integrator import gather_tables as jgt
from tpuray.integrator import path_tracer as jpt
from tpuray.render.frame_state import FrameState as JFrameState
from tpuray.render.renderer import render_frame as jrender_frame
from tpuray.scene.camera import OrbitCamera as JOrbitCamera
from tpuray.scene.config import RenderConfig as JRenderConfig

from tpuray_torch.integrator import gather_tables as gt
from tpuray_torch.integrator import path_tracer
from tpuray_torch.render.renderer import Renderer
from tpuray_torch.scene import builder
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.procedural import write_test_scene_obj

from tests.test_torch_native import port_numpy_builders

torch.set_num_threads(2)

TEX_RES = 32
SIZE = 64
SCALE = (2.0, 2.0, 2.0)  # the sphere and ground cover ~10% of the view


@contextlib.contextmanager
def numpy_builders():
    """Both packages' build_scene with their numpy OBJ parser, BVH builder
    and env cache: the two native libraries' builds differ (the JAX
    package's is built with -march=native)."""
    saved = (jbuilder.build_bvh, jpart.build_bvh, jnative.parse_obj_native,
             jnative.env_cache_native)

    def bvh_py(tv, leaf=8, force_py=False):
        return jbvh.build_bvh(tv, leaf, force_py=True)

    jbuilder.build_bvh = jpart.build_bvh = bvh_py
    jnative.parse_obj_native = jnative.env_cache_native = lambda *a: None
    try:
        with port_numpy_builders():
            yield
    finally:
        (jbuilder.build_bvh, jpart.build_bvh, jnative.parse_obj_native,
         jnative.env_cache_native) = saved


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("obj") / "scene.obj")
    write_test_scene_obj(path, subdiv=2)
    kw = dict(point_lights=builder.DEFAULT_LIGHTS, with_textures=True,
              texture_res=TEX_RES, envmap=jbuilder.procedural_room_envmap(64))
    with numpy_builders():
        js = jbuilder.build_scene(
            [jbuilder.ObjectSpec(path=path, material=dict(builder.DEFAULT_MATERIAL),
                                 scale=SCALE)], **kw)
        ts = builder.build_scene(
            [builder.ObjectSpec(path=path, material=dict(builder.DEFAULT_MATERIAL),
                                scale=SCALE)], **kw)
    return js, ts


def _layers(seed, byte_grid):
    rs = np.random.default_rng(seed)
    tex = rs.random((2, 4, 8, 12, 3)).astype(np.float32)
    if byte_grid:
        tex = (np.round(tex * 255.0) / 255.0).astype(np.float32)
    return tex


@pytest.mark.parametrize("byte_grid", [False, True], ids=["float", "bytes"])
def test_pack_texture_stack_bits(byte_grid):
    tex = _layers(3, byte_grid)
    got = gt.pack_texture_stack(torch.from_numpy(tex))
    want = np.asarray(jgt.pack_texture_stack(jnp.asarray(tex)))  # (O, H, W, 20)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 8, 12, 5)
    bits = got.view(torch.int16).numpy().view(np.uint16)
    want_bits = want.view(np.uint16)
    # tpuray's quad: texel, right, down, down-right neighbours (clamped)
    right = np.concatenate([bits[:, :, 1:], bits[:, :, -1:]], axis=2)
    down = np.concatenate([bits[:, 1:], bits[:, -1:]], axis=1)
    down_right = np.concatenate([down[:, :, 1:], down[:, :, -1:]], axis=2)
    np.testing.assert_array_equal(
        np.concatenate([bits, right, down, down_right], axis=-1), want_bits)
    if byte_grid:  # integers 0..255: exact in bf16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.round(np.concatenate(
                                          [tex[:, 0], tex[:, 1, ..., :1], tex[:, 3, ..., :1]],
                                          -1).astype(np.float32) * 255.0))


def _taps(seed, n=4096):
    rs = np.random.default_rng(seed)
    obj = rs.integers(0, 2, n).astype(np.int32)
    uv = rs.random((n, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [1, 1], [0, 1], [1, 0], [0.5, 0.0], [1.0, 0.5],
              [1e-7, 1 - 1e-7], [0.999, 0.001]]
    return obj, uv


def test_tex_fetch_packed_matches():
    tex = _layers(5, False)
    obj, uv = _taps(6)
    got = gt.tex_fetch_packed(gt.pack_texture_stack(torch.from_numpy(tex)),
                              torch.from_numpy(obj).long(), torch.from_numpy(uv[:, 0]),
                              torch.from_numpy(uv[:, 1]))
    want = jgt.tex_fetch_packed(jgt.pack_texture_stack(jnp.asarray(tex)), jnp.asarray(obj),
                                jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


class _Textures:
    def __init__(self, data):
        self.textures = type("T", (), {"data": data})


def test_normal_layer_fetch_matches():
    """gather_tables.tex_fetch on the f32 normal layer against tpuray's
    path_tracer._tex_fetch (layer 2), uv outside [0, 1] and object ids out
    of range included (both clamp)."""
    tex = _layers(7, False)
    obj, uv = _taps(8)
    uv = uv * 1.2 - 0.1
    obj[:4] = [-1, 2, 5, 1]
    got = gt.tex_fetch(torch.from_numpy(tex[:, 2].copy()), torch.from_numpy(obj).long(),
                       torch.from_numpy(uv))
    want = jpt._tex_fetch(_Textures(jnp.asarray(tex)), jnp.asarray(obj), 2,
                          jnp.asarray(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_build_scene_textures(scenes):
    js, ts = scenes
    np.testing.assert_array_equal(ts.textures.data.numpy(), np.asarray(js.textures.data))
    assert ts.textures.n_objects == 1
    assert float(ts.materials.base_color.max()) == -1.0  # the sentinels
    uv = ts.triangles.uv1.numpy()
    assert np.ptp(uv[:, 0]) > 0.5 and np.ptp(uv[:, 1]) > 0.5


@pytest.mark.parametrize("normal_map", [False, True], ids=["sentinels", "normal_map"])
def test_resolve_hit_matches(scenes, normal_map):
    js, ts = scenes
    cam = OrbitCamera(width=SIZE, height=SIZE).snapshot()
    d = cam.ray_directions(SIZE, SIZE).reshape(-1, 3)
    o = cam.eye.expand(d.shape[0], 3).contiguous()
    tables = path_tracer.pack_traversal(ts)
    t, idx = path_tracer.trace(path_tracer.KERNELS, tables, o, d, common_origin=True)
    assert 0.05 < float((idx >= 0).float().mean()) < 0.5
    cfg = dict(use_normal_map=normal_map)
    hit = path_tracer.resolve_hit(gt.pack_scene_tables(ts), o, d, t, idx,
                                  RenderConfig(**cfg))
    jhit = jpt.resolve_hit(js, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                           jnp.asarray(t.numpy()), jnp.asarray(idx.numpy()),
                           JRenderConfig(**cfg))
    v = idx.numpy() >= 0
    np.testing.assert_array_equal(hit.valid.numpy(), np.asarray(jhit.valid))
    for name, a, b in [("point", hit.point, jhit.point), ("normal", hit.normal, jhit.normal),
                       *[(f, getattr(hit.mat, f), getattr(jhit.mat, f))
                         for f in hit.mat._fields]]:
        np.testing.assert_allclose(a.numpy()[v], np.asarray(b)[v], rtol=0, atol=1e-6,
                                   err_msg=name)
    # the textures are live: texels, not the -1 sentinels, on every hit
    assert float(hit.mat.base_color[v].min()) >= 0.0
    assert np.ptp(hit.mat.metallic.numpy()[v]) > 0.1


def assert_images_close(a, b, tol=5e-4, outlier_frac=0.005, outlier_max=0.1, msg=""):
    d = np.abs(np.asarray(a) - np.asarray(b)).max(-1)
    frac = float((d > tol).mean())
    assert frac <= outlier_frac, f"{msg}: {frac:.4%} pixels differ > {tol}"
    assert d.max() < outlier_max, f"{msg}: max diff {d.max():.4f}"


def test_default_config_frame_matches(scenes):
    """One frame of the textured file scene under the default RenderConfig
    at 64x64: the port's Renderer against tpuray's render_frame."""
    js, ts = scenes
    cfg = RenderConfig(width=SIZE, height=SIZE)
    assert (cfg.compact_frac, cfg.compact_auto) == (0.5, True)
    out = Renderer(ts, cfg, device="cpu").step(OrbitCamera(width=SIZE, height=SIZE).snapshot())
    jcfg = JRenderConfig(width=SIZE, height=SIZE)
    _, jout = jrender_frame(js, JOrbitCamera(width=SIZE, height=SIZE).snapshot(),
                            JFrameState.initial(SIZE, SIZE), jcfg, SIZE, SIZE)
    assert float(out.coverage) == float(jout.coverage)
    assert 0.05 < float(out.coverage) < 0.5
    np.testing.assert_array_equal(out.gbuffer.linear_z.numpy() != 1.0,
                                  np.asarray(jout.gbuffer.linear_z) != 1.0)
    assert_images_close(out.pt_color.numpy(), jout.pt_color, msg="pt_color")
    assert_images_close(out.final.numpy(), jout.final, msg="final")
    assert bool(torch.isfinite(out.final).all())
