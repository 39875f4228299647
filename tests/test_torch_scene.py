"""tpuray_torch scene layer vs the JAX package: procedural scene, BVH
builder, env cache, RenderConfig, OrbitCamera and tile order. Every
comparison here is exact (the port's host code is a numpy copy)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import tpuray.scene.procedural as jproc
from tpuray.accel.bvh import build_bvh
from tpuray.io import fallback
from tpuray.render import tiling as jtiling
from tpuray.scene.camera import OrbitCamera as JOrbitCamera
from tpuray.scene.config import RenderConfig as JRenderConfig

from tpuray_torch.render import tiling
from tpuray_torch.scene import host

from tests.test_torch_native import port_numpy_builders
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.procedural import make_test_scene_arrays
from tpuray_torch.scene.types import scene_from_numpy, scene_to_numpy

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_scene():
    """tpuray's make_test_scene with the numpy BVH builder forced."""
    orig = jproc.build_bvh
    jproc.build_bvh = functools.partial(build_bvh, force_py=True)
    try:
        return jproc.make_test_scene(subdiv=2, env_width=32)
    finally:
        jproc.build_bvh = orig


def test_make_test_scene_matches_jax(jax_scene):
    """Both packages on their numpy BVH builders (the native builds differ:
    the JAX package's library is built with -march=native, whose FMAs move
    the split costs)."""
    with port_numpy_builders():
        ours = make_test_scene_arrays(subdiv=2, env_width=32)
    ref = scene_to_numpy(jax_scene)
    # the JAX scene's cache comes from the native builder; the port's is
    # env_cache_py's here, held to it below
    for key, want in ref.items():
        if key in ("envmap.cache", "bvh.chunk_nodes", "bvh.chunk_tris"):
            continue
        got = ours[key]
        np.testing.assert_array_equal(
            np.asarray(got, want.dtype), want, err_msg=key)
    assert set(ours) == set(ref) - {"bvh.chunk_nodes", "bvh.chunk_tris"}


def test_env_cache_matches_fallback():
    img = host.procedural_room_envmap(64)
    from tpuray.scene.builder import procedural_room_envmap
    np.testing.assert_array_equal(img, procedural_room_envmap(64))
    np.testing.assert_array_equal(host.env_cache_py(img),
                                  fallback.env_cache_py(img))


@pytest.mark.parametrize("n_tris,leaf", [(1, 8), (50, 4), (700, 8)])
def test_build_bvh_matches_fallback(n_tris, leaf):
    rs = np.random.default_rng(n_tris)
    centers = rs.random((n_tris, 1, 3)).astype(np.float32) * 4.0
    tris = centers + (rs.random((n_tris, 3, 3)).astype(np.float32) - 0.5) * 0.3
    got = host.build_bvh_py(tris, leaf)
    want = fallback.build_bvh_py(tris, leaf)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_scene_round_trip_through_numpy(jax_scene):
    arrays = scene_to_numpy(jax_scene)
    scene = scene_from_numpy(arrays)
    back = scene_to_numpy(scene)
    for key, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(arrays[key], v.dtype),
                                      err_msg=key)
    assert scene.triangles.mat_id.dtype == torch.int32
    assert scene.bvh.count == jax_scene.bvh.count


def test_scene_from_numpy_rejects_unported():
    """A texture stack and a forest's chunk sizes (0-d arrays) load."""
    arrays = make_test_scene_arrays(subdiv=0, env_width=16)
    tex = np.random.default_rng(0).random((1, 4, 2, 2, 3))
    scene = scene_from_numpy(dict(arrays, **{"textures.data": tex}))
    assert scene.textures.data.dtype == torch.float32
    np.testing.assert_array_equal(scene.textures.data.numpy(), tex.astype(np.float32))
    np.testing.assert_array_equal(scene_to_numpy(scene)["textures.data"],
                                  tex.astype(np.float32))
    assert scene_from_numpy(arrays).textures is None
    forest = scene_from_numpy(dict(arrays, **{"bvh.chunk_nodes": np.asarray(128),
                                              "bvh.chunk_tris": np.asarray(256)}))
    assert (forest.bvh.chunk_nodes, forest.bvh.chunk_tris) == (128, 256)
    assert scene_from_numpy(arrays).bvh.chunk_nodes == 0


def test_render_config_fields_and_defaults():
    ours = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JRenderConfig)}
    assert ours == ref
    assert RenderConfig.from_json(RenderConfig().to_json()) == RenderConfig()


@pytest.mark.parametrize("pose", [
    dict(), dict(yaw_deg=33.0, pitch_deg=-20.0, radius=3.5),
    dict(width=64, height=48, fov_y_deg=60.0, pan=np.asarray([0.2, -0.1, 0.4])),
])
def test_orbit_camera_snapshot_bit_equal(pose):
    ours, ref = OrbitCamera(**pose), JOrbitCamera(**pose)
    for cam in (ours, ref):
        cam.rotate(7.5, 3.0)
        cam.dolly(0.25)
        cam.pan_by(0.1, -0.2)
    a, b = ours.snapshot(), ref.snapshot()
    for name in ("eye", "cam_to_world", "view_proj", "tan_half_fov"):
        got = getattr(a, name).numpy()
        want = np.asarray(getattr(b, name))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("h,w", [(48, 48), (40, 72), (32, 96)])
def test_tiling_bit_equal(h, w):
    xx, yy = tiling.tile_pixel_coords(h, w)
    jx, jy = jtiling.tile_pixel_coords(h, w)
    np.testing.assert_array_equal(xx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(yy.numpy(), np.asarray(jy))
    flat = np.random.default_rng(h * w).random((xx.shape[0], 3)).astype(np.float32)
    img = tiling.untile(torch.from_numpy(flat), h, w)
    np.testing.assert_array_equal(img.numpy(),
                                  np.asarray(jtiling.untile(flat, h, w)))
