"""The port's native host library (tpuray_torch/io/native.py over
csrc/tpuray_native.cpp) on the CPU, against the port's numpy copies and
against tpuray.io.native, on files written to tmp_path from seeded data.

- The .cpp is tpuray's byte for byte but for one comment line, and the
  library builds into the git-ignored build/ (never into tpuray/), once,
  when two processes start the build together.
- The readers (OBJ, RGBE, BMP) and the RGBE writer: bit for bit the numpy
  versions' results and tpuray's native ones.
- The BVH at t in {3, 17, 150, 999} random triangles (tests/test_bvh.py's
  generator, five seeds): first_tri, tri_count, skip and perm equal to
  build_bvh_py's, the boxes within atol 1e-6 (test_bvh.py's tolerance).
  Against tpuray's native build: equal wherever tpuray's own build equals
  its numpy oracle. tpuray's library is built with -march=native
  (tpuray/native/Makefile), and its FMAs move a split cost by an ulp on a
  few inputs (4 of 80 here); the port builds with the portable flags, and
  its tree is the numpy one.
- On an OBJ of the test scene (write_test_scene_obj): the parse is exact;
  the tree equals build_bvh_py's but for the order of the ground quad's two
  triangles inside their leaf (std::sort and numpy's stable sort order a
  tie of centroids differently): each leaf holds the same triangles.
- The env cache: sample columns exact against env_cache_py, the pdf within
  rtol 1e-6 (float against float64 sums), bit for bit tpuray's native one.
- The selection: without the library every entry returns None and the
  scene builders take their numpy versions; the port's builders call the
  native entries wherever tpuray's do, as many times.
"""
import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest

import tpuray.accel.bvh as jbvh
import tpuray.io.native as jnative
import tpuray.scene.builder as jbuilder
import tpuray.scene.partition as jpart
import tpuray.scene.procedural as jproc
from tpuray.io import fallback as jfb

from tpuray_torch.accel import bvh
from tpuray_torch.io import fallback, hdr, image, native, obj
from tpuray_torch.scene import builder, host, partition, procedural
from tpuray_torch.scene.procedural import write_test_scene_obj

from tests.test_torch_io import OBJ_TEXT, _bmp_bytes, _hdr_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT_KEYS = ("first_tri", "tri_count", "skip", "perm")
BOX_KEYS = ("aabb_min", "aabb_max")


@contextlib.contextmanager
def port_numpy_builders():
    """The port's host builders on their numpy versions: the native library
    reported absent, as on a machine without g++."""
    saved = native.get_lib
    native.get_lib = lambda: None
    try:
        yield
    finally:
        native.get_lib = saved


def random_tris(rng, t=64, spread=4.0):
    centers = (rng.random((t, 1, 3)) - 0.5) * spread
    verts = centers + (rng.random((t, 3, 3)) - 0.5) * 0.6
    return verts.astype(np.float32)


def assert_tree_matches(got, want, msg=""):
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {msg}")
    for k in BOX_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=f"{k} {msg}")


def test_source_is_tpurays():
    """The port's copy is tpuray's file byte for byte but for one line of
    its header comment, which names where the original renderer's sources
    were mounted on the machine that wrote it."""
    ours = native.SOURCE.read_bytes().splitlines(keepends=True)
    with open(os.path.join(ROOT, "tpuray", "native", "tpuray_native.cpp"), "rb") as f:
        theirs = f.read().splitlines(keepends=True)
    assert len(ours) == len(theirs)
    differ = [i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b]
    assert differ == [3] and ours[3].startswith(b"// (the original renderer's Utils/")
    assert ours[3].split(b"Utils/", 1)[1] == theirs[3].split(b"Utils/", 1)[1]


def test_library_builds_into_build_dir():
    assert native.available()
    path = native.library_path()
    assert path.exists()
    assert path.is_relative_to(os.path.join(ROOT, "build"))
    assert native.get_lib() is native.get_lib()


def test_two_processes_build_once(tmp_path):
    """Two processes build into an empty directory at once: one compiles,
    the other waits on the lock and loads its library; no temporary file
    is left."""
    code = (f"import pathlib, sys; sys.path.insert(0, {ROOT!r})\n"
            "from tpuray_torch.io import native\n"
            f"native.BUILD_ROOT = pathlib.Path({str(tmp_path)!r})\n"
            "assert native.available(), native.build_log\n"
            "print(native.build_seconds)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    seconds = sorted(float(o.strip()) for o, _ in outs)
    assert seconds[0] == 0.0 < seconds[1], seconds
    built = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert sorted(p.name for p in built) == ["libtpuray_native.so", "lock"]


def test_failed_build_returns_none(tmp_path, monkeypatch):
    """No g++: every entry returns None and the builders take numpy."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    monkeypatch.setattr(native, "build_log", "")
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    assert "g++ not found" in native.build_log
    tris = random_tris(np.random.default_rng(0), 40)
    assert native.build_bvh_native(tris) is None
    assert native.env_cache_native(np.ones((4, 8, 3), np.float32)) is None
    assert native.write_hdr_native(str(tmp_path / "x.hdr"), np.ones((2, 2, 3))) is False
    got = bvh.build_bvh(tris)
    for k, v in host.build_bvh_py(tris).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("t", [3, 17, 150, 999])
def test_bvh_matches_numpy_and_tpuray(t):
    compared = 0
    for seed in range(5):
        verts = random_tris(np.random.default_rng(seed * 10_000 + t), t)
        got = native.build_bvh_native(verts, 8)
        py = host.build_bvh_py(verts, 8)
        assert_tree_matches(got, py, f"t={t} seed={seed}")
        jbvh.validate_bvh(got, verts, 8)
        theirs = jnative.build_bvh_native(verts, 8)
        if all(np.array_equal(theirs[k], py[k]) for k in INT_KEYS):
            assert_tree_matches(got, theirs, f"tpuray t={t} seed={seed}")
            compared += 1
    assert compared >= 3
    for force_py, want in ((False, got), (True, py)):
        sel = bvh.build_bvh(verts, 8, force_py=force_py)
        for k in INT_KEYS + BOX_KEYS:
            np.testing.assert_array_equal(sel[k], want[k], err_msg=k)


def _leaf_sets(tree):
    return [sorted(tree["perm"][f:f + c].tolist())
            for f, c in zip(tree["first_tri"], tree["tri_count"]) if c > 0]


def test_test_scene_obj(tmp_path):
    path = str(tmp_path / "scene.obj")
    write_test_scene_obj(path, subdiv=2)
    got = native.parse_obj_native(path)
    for g, w, j in zip(got, fallback.parse_obj_py(path), jnative.parse_obj_native(path)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)
    tris = obj.load_obj(path)["positions"]
    tree, py = native.build_bvh_native(tris, 8), host.build_bvh_py(tris, 8)
    assert_tree_matches({**tree, "perm": py["perm"]}, py)
    assert _leaf_sets(tree) == _leaf_sets(py)
    assert (tree["perm"] != py["perm"]).sum() <= 2  # the ground's tie


def test_obj_faces(tmp_path):
    """Quads, polygons and faces with and without texcoords or normals."""
    p = tmp_path / "mesh.obj"
    p.write_text(OBJ_TEXT)
    for g, w, j in zip(obj.parse_obj(str(p)), jfb.parse_obj_py(str(p)),
                       jnative.parse_obj_native(str(p))):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)


def test_hdr(tmp_path):
    img = _hdr_image(5)
    a, b = str(tmp_path / "a.hdr"), str(tmp_path / "b.hdr")
    assert native.write_hdr_native(a, img)
    fallback.write_hdr_py(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
    for p in (a, os.path.join(ROOT, "assets", "recovered_env.hdr")):
        got = native.read_hdr_native(p)
        np.testing.assert_array_equal(got, fallback.read_hdr_py(p))
        np.testing.assert_array_equal(got, jnative.read_hdr_native(p))
        np.testing.assert_array_equal(hdr.read_hdr(p), got)


@pytest.mark.parametrize("bpp,topdown", [(24, False), (32, True)])
def test_bmp(tmp_path, bpp, topdown):
    rgba = np.random.default_rng(bpp).integers(0, 256, (9, 11, 4), dtype=np.uint8)
    p = str(tmp_path / "t.bmp")
    open(p, "wb").write(_bmp_bytes(rgba, bpp, topdown))
    got = native.read_bmp_native(p)
    np.testing.assert_array_equal(got, fallback.read_bmp_py(p))
    np.testing.assert_array_equal(got, jnative.read_bmp_native(p))
    np.testing.assert_array_equal(image.read_bmp(p), got)


@pytest.mark.parametrize("width", [64, 512])
def test_env_cache(width):
    img = host.procedural_room_envmap(width)
    got = native.env_cache_native(img)
    want = host.env_cache_py(img)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got, jnative.env_cache_native(img))
    np.testing.assert_array_equal(builder.make_env_cache(img), got)
    with port_numpy_builders():
        np.testing.assert_array_equal(builder.make_env_cache(img), want)


def _counting(module, names, calls, tag):
    """Wrap module's entries so that each call is counted under tag."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(n, fn):
        def counted(*a, **k):
            calls[tag, n] = calls.get((tag, n), 0) + 1
            return fn(*a, **k)
        return counted

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    return saved


def test_builders_call_native_where_tpuray_does(tmp_path):
    """make_test_scene, make_large_scene and build_scene (an OBJ, an HDR
    env map, a BMP texture) in both packages: each native entry is called
    as many times by the port as by tpuray."""
    names = ("parse_obj_native", "read_hdr_native", "read_bmp_native",
             "build_bvh_native", "env_cache_native")
    path = str(tmp_path / "s.obj")
    write_test_scene_obj(path, subdiv=1)
    env = str(tmp_path / "env.hdr")
    hdr.write_hdr(env, host.procedural_room_envmap(32))
    tex = str(tmp_path / "a.bmp")
    image.write_bmp(tex, np.random.default_rng(1).random((8, 8, 3)))
    layers = dict(albedo=tex, metallic=tex, normal=tex, roughness=tex)
    large = dict(n_spheres=3, subdiv=1, max_chunk_tris=64, env_width=32)
    calls = {}
    saved = {"port": _counting(native, names, calls, "port"),
             "tpuray": _counting(jnative, names, calls, "tpuray")}
    try:
        for pkg, proc, build in (("port", procedural, builder), ("tpuray", jproc, jbuilder)):
            proc.make_test_scene(subdiv=1, env_width=32)
            proc.make_large_scene(**large)
            build.build_scene([build.ObjectSpec(path=path, textures=layers)], envmap=env,
                              with_textures=True, texture_res=8)
    finally:
        for module, kept in ((native, saved["port"]), (jnative, saved["tpuray"])):
            for n, fn in kept.items():
                setattr(module, n, fn)
    for n in names:
        assert calls.get(("port", n), 0) == calls.get(("tpuray", n), 0) > 0, n


def test_forest_force_py_reaches_every_chunk():
    tris = random_tris(np.random.default_rng(3), 300)
    for ours, theirs in ((partition.build_forest_bvh, jpart.build_forest_bvh),
                         (partition.build_forest_bvh_uniform,
                          jpart.build_forest_bvh_uniform)):
        py = ours(tris, 8, 64, force_py=True)
        ref = theirs(tris, 8, 64, force_py=True)
        nat = ours(tris, 8, 64)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(py[k]), np.asarray(ref[k]), err_msg=k)
            if k in BOX_KEYS:
                np.testing.assert_allclose(nat[k], ref[k], rtol=0, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(np.asarray(nat[k]), np.asarray(ref[k]), err_msg=k)
