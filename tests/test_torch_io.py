"""The port's asset readers and writers and scene builder (tpuray_torch/io,
scene/builder.py, utils/checkpoint.py) against tpuray's numpy fallbacks on
the CPU, on files written to tmp_path from seeded numpy data.

Every reader is held bit for bit against tpuray's fallback (the native
library's numpy oracle); every writer gives the same bytes. build_scene's
arrays equal tpuray's with its numpy builders forced, on each side of the
single-tree / forest layout rule.
"""
import os
import struct
import zlib

import numpy as np
import pytest
import jax.numpy as jnp

import tpuray.accel.bvh as jbvh
import tpuray.io.native as jnative
import tpuray.scene.builder as jbuilder
import tpuray.scene.partition as jpart
from tpuray.io import fallback as jfb
from tpuray.io import filesystem as jfs
from tpuray.io import image as jimage
from tpuray.io import obj as jobj
from tpuray.kernels.trace_pallas import scene_fits_smem
from tpuray.render.frame_state import FrameState as JFrameState
from tpuray.utils import checkpoint as jckpt
from tpuray.utils.metrics import FrameMetrics as JFrameMetrics

from tpuray_torch.io import filesystem, hdr, image, obj
from tpuray_torch.io import native as tnative
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.scene import builder
from tpuray_torch.scene.procedural import write_test_scene_obj
from tpuray_torch.scene.types import scene_to_numpy
from tpuray_torch.utils import checkpoint
from tpuray_torch.utils.metrics import FrameMetrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OBJ_TEXT = """# a quad, a triangle and a polygon, every face form
v 0.0 0.0 0.0
v 2.0 0.0 0.0
v 2.0 1.0 0.5
v 0.0 1.0 0.5
v 1.0 3.0 -1.0
vt 0.0 0.0
vt 1.0 0.0
vt 1.0 1.0
vt 0.0 1.0
vn 0.0 0.0 1.0
vn 0.0 1.0 0.0
f 1/1/1 2/2/1 3/3/1
f 1/1/1 3/3/1 4/4/1
f 4//2 3//2 5//2
f 1 2 5 4
f 2/2 5/4 3/3

"""


@pytest.fixture(scope="module")
def obj_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("obj") / "mesh.obj"
    p.write_text(OBJ_TEXT)
    return str(p)


def test_parse_obj_matches(obj_path):
    got = obj.parse_obj(obj_path)
    want = jfb.parse_obj_py(obj_path)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3][2].tolist() == [-1, -1, -1]  # faces without texcoords


@pytest.mark.parametrize("smooth,quirks,trs", [
    (True, False, None), (False, False, None), (True, True, None),
    (True, False, ((10.0, 20.0, 30.0), (0.1, -0.2, 0.3), (2.0, 1.0, 0.5)))],
    ids=["smooth", "flat", "quirks", "trs"])
def test_load_obj_matches(obj_path, smooth, quirks, trs):
    tm = obj.transform_matrix(*trs) if trs else None
    if trs:
        np.testing.assert_array_equal(tm, jobj.transform_matrix(*trs))
    got = obj.load_obj(obj_path, tm, smooth, reference_quirks=quirks)
    want = jobj.load_obj(obj_path, tm, smooth, reference_quirks=quirks)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_write_obj_round_trip(tmp_path):
    rs = np.random.default_rng(1)
    v = rs.random((7, 3)).astype(np.float32)
    vt = rs.random((9, 2)).astype(np.float32)
    f = rs.integers(0, 7, (5, 3))
    ft = rs.integers(0, 9, (5, 3))
    p = str(tmp_path / "w.obj")
    obj.write_obj(p, v, f, vt, ft)
    pos, uv, fv, fvt = jfb.parse_obj_py(p)
    np.testing.assert_array_equal(pos, v)
    np.testing.assert_array_equal(uv, vt)
    np.testing.assert_array_equal(fv, f)
    np.testing.assert_array_equal(fvt, ft)


def _hdr_image(seed, h=6, w=10):
    rs = np.random.default_rng(seed)
    img = (rs.random((h, w, 3)) ** 3 * 50.0).astype(np.float32)
    img[0, :3] = 0.0
    img[1, 2] = [1e-33, 0.0, 0.0]  # below the RGBE floor
    return img


def _rle_channel(vals: bytes) -> bytes:
    """New-style RLE of one channel: runs of >= 3 equal bytes as run
    packets, the rest as literal packets."""
    out, i, n = bytearray(), 0, len(vals)
    while i < n:
        j = i
        while j < n and vals[j] == vals[i] and j - i < 127:
            j += 1
        if j - i >= 3:
            out += bytes([128 + j - i, vals[i]])
            i = j
        else:
            k = i
            while k < n and k - i < 128 and not (k + 2 < n and vals[k] == vals[k + 1] == vals[k + 2]):
                k += 1
            k = max(k, i + 1)
            out += bytes([k - i]) + vals[i:k]
            i = k
    return bytes(out)


def _rgbe(path):
    """The flat file's RGBE bytes (h, w, 4) and its header."""
    data = open(path, "rb").read()
    head_end = data.index(b"\n", data.index(b"-Y")) + 1
    return data[:head_end], np.frombuffer(data[head_end:], np.uint8)


def test_hdr_writer_and_flat_reader(tmp_path):
    img = _hdr_image(2)
    a, b = str(tmp_path / "a.hdr"), str(tmp_path / "b.hdr")
    hdr.write_hdr(a, img)
    jfb.write_hdr_py(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
    got = hdr.read_hdr(a)
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_array_equal(got, jfb.read_hdr_py(a))
    # RGBE keeps 8 bits of mantissa against the brightest channel
    assert (np.abs(got - img) <= img.max(-1, keepdims=True) / 128 + 1e-30).all()


@pytest.mark.parametrize("mode", ["rle", "old_rle"])
def test_hdr_rle_reader(tmp_path, mode):
    img = _hdr_image(3, h=5, w=12)
    img[2, 4:11] = img[2, 4]  # a run
    flat = str(tmp_path / "flat.hdr")
    jfb.write_hdr_py(flat, img)
    header, e = _rgbe(flat)
    e = e.reshape(5, 12, 4)
    body = bytearray()
    for y in range(5):
        if mode == "rle":
            body += bytes([2, 2, 0, 12])
            for c in range(4):
                body += _rle_channel(e[y, :, c].tobytes())
        else:  # flat pixels, with a repeat code for the run in row 2
            row = [e[y, x].tobytes() for x in range(12)]
            if y == 2:
                row = row[:5] + [bytes([1, 1, 1, 6])] + row[11:]
            body += b"".join(row)
    p = str(tmp_path / f"{mode}.hdr")
    with open(p, "wb") as f:
        f.write(header + bytes(body))
    got = hdr.read_hdr(p)
    np.testing.assert_array_equal(got, jfb.read_hdr_py(p))
    np.testing.assert_array_equal(got, jfb.read_hdr_py(flat))


def test_hdr_asset_matches():
    """The repository's own env map (new-style RLE)."""
    p = os.path.join(ROOT, "assets", "recovered_env.hdr")
    got = hdr.read_hdr(p)
    np.testing.assert_array_equal(got, jfb.read_hdr_py(p))
    assert got.shape[-1] == 3 and got.max() > 1.0


def _bmp_bytes(rgba, bpp, topdown):
    h, w = rgba.shape[:2]
    bypp = bpp // 8
    stride = (w * bypp + 3) & ~3
    px = rgba[..., [2, 1, 0, 3]][..., :bypp]
    rows = px if topdown else px[::-1]
    data = np.zeros((h, stride), np.uint8)
    data[:, :w * bypp] = rows.reshape(h, -1)
    header = bytearray(54)
    header[0:2] = b"BM"
    header[10:14] = (54).to_bytes(4, "little")
    header[14:18] = (40).to_bytes(4, "little")
    header[18:22] = w.to_bytes(4, "little")
    header[22:26] = (-h if topdown else h).to_bytes(4, "little", signed=True)
    header[28:30] = bpp.to_bytes(2, "little")
    return bytes(header) + data.tobytes()


@pytest.mark.parametrize("bpp,topdown", [(24, False), (32, True), (24, True)])
def test_bmp_reader(tmp_path, bpp, topdown):
    rgba = np.random.default_rng(bpp).integers(0, 256, (5, 7, 4), dtype=np.uint8)
    p = tmp_path / "t.bmp"
    p.write_bytes(_bmp_bytes(rgba, bpp, topdown))
    got = image.read_bmp(str(p))
    np.testing.assert_array_equal(got, jfb.read_bmp_py(str(p)))
    np.testing.assert_array_equal(got[..., :3], rgba[..., :3])
    np.testing.assert_array_equal(image.read_image(str(p)), jimage.read_image(str(p)))


@pytest.mark.parametrize("dtype", ["float", "uint8"])
def test_bmp_writer(tmp_path, dtype):
    rs = np.random.default_rng(4)
    img = rs.random((6, 5, 3)).astype(np.float32)
    if dtype == "uint8":
        img = (img * 255).astype(np.uint8)
    a, b = str(tmp_path / "a.bmp"), str(tmp_path / "b.bmp")
    image.write_bmp(a, img)
    jfb.write_bmp_py(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(image.read_bmp(a), jfb.read_bmp_py(a))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _png_filtered(img: np.ndarray, color_type: int) -> bytes:
    """A PNG whose rows cycle through filters 0-4 (None, Sub, Up, Average,
    Paeth)."""
    h, w, nch = img.shape
    rows = img.reshape(h, w * nch).astype(np.int64)
    raw, prev = bytearray(), np.zeros(w * nch, np.int64)
    for y in range(h):
        ft = y % 5
        cur, out = rows[y], []
        for x in range(w * nch):
            a = cur[x - nch] if x >= nch else 0
            b = prev[x]
            c = prev[x - nch] if x >= nch else 0
            pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][ft]
            out.append((cur[x] - pred) & 0xFF)
        raw += bytes([ft]) + bytes(out)
        prev = cur

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("color_type,nch", [(2, 3), (6, 4), (0, 1), (4, 2)],
                         ids=["rgb", "rgba", "gray", "gray_alpha"])
def test_png_reader(tmp_path, color_type, nch):
    """Filters 0-4 on every color type, against tpuray's read_png (PIL where
    it is installed, its stdlib decoder otherwise)."""
    img = np.random.default_rng(color_type).integers(0, 256, (10, 9, nch), dtype=np.uint8)
    p = tmp_path / "f.png"
    p.write_bytes(_png_filtered(img, color_type))
    got = image.read_png(str(p))
    want = jimage.read_png(str(p))
    assert got.dtype == np.float32 and got.shape == (10, 9, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., 0], img[..., 0].astype(np.float32) / 255.0)
    np.testing.assert_array_equal(image.read_image(str(p)), want)


@pytest.mark.parametrize("dtype", ["float", "uint8"])
def test_png_writer(tmp_path, dtype):
    rs = np.random.default_rng(5)
    img = rs.random((7, 11, 3)).astype(np.float32)
    if dtype == "uint8":
        img = (img * 255).astype(np.uint8)
    assert image.encode_png(img) == jimage.encode_png(img)
    p = str(tmp_path / "w.png")
    image.write_png(p, img)
    np.testing.assert_array_equal(image.read_png(p), jimage.read_png(p))


def _tga_bytes(px: np.ndarray, img_type: int, top_down: bool, id_text=b"tpu") -> bytes:
    """TGA of (H, W, nch) BGR(A)/gray pixels stored in file order."""
    h, w, nch = px.shape
    head = bytes([len(id_text), 0, img_type, 0, 0, 0, 0, 0, 0, 0, 0, 0])
    head += struct.pack("<HH", w, h) + bytes([nch * 8, 0x20 if top_down else 0])
    flat = px.reshape(-1, nch)
    if img_type in (2, 3):
        return head + id_text + flat.tobytes()
    body, i = bytearray(), 0  # RLE: runs of equal pixels, raw packets between
    while i < len(flat):
        j = i
        while j < len(flat) and j - i < 128 and (flat[j] == flat[i]).all():
            j += 1
        if j - i >= 2:
            body += bytes([0x80 | (j - i - 1)]) + flat[i].tobytes()
            i = j
        else:
            k = min(i + 1, len(flat))
            while k < len(flat) and k - i < 128 and not (
                    k + 1 < len(flat) and (flat[k] == flat[k + 1]).all()):
                k += 1
            body += bytes([k - i - 1]) + flat[i:k].tobytes()
            i = k
    return head + id_text + bytes(body)


@pytest.mark.parametrize("img_type,nch,top_down", [
    (2, 3, False), (2, 4, True), (3, 1, False), (10, 3, True), (10, 4, False),
    (11, 1, True)], ids=["raw24", "raw32", "raw8", "rle24", "rle32", "rle8"])
def test_tga_reader(tmp_path, img_type, nch, top_down):
    rs = np.random.default_rng(img_type * 10 + nch)
    px = rs.integers(0, 4, (6, 9, nch), dtype=np.uint8) * 60  # runs for RLE
    p = tmp_path / "t.tga"
    p.write_bytes(_tga_bytes(px, img_type, top_down))
    got = image.read_tga(str(p))
    np.testing.assert_array_equal(got, jimage.read_tga(str(p)))
    np.testing.assert_array_equal(image.read_image(str(p)), jimage.read_image(str(p)))
    rgb = np.repeat(px, 3, -1) if nch == 1 else px[..., 2::-1]
    if not top_down:
        rgb = rgb[::-1]
    np.testing.assert_array_equal(got, rgb.astype(np.float32) / 255.0)


def test_read_image_hdr_and_unknown(tmp_path):
    p = str(tmp_path / "e.hdr")
    hdr.write_hdr(p, _hdr_image(6))
    np.testing.assert_array_equal(image.read_image(p), jfb.read_hdr_py(p))
    q = tmp_path / "x.dat"
    q.write_bytes(b"\x00\x01\x02\x03rest")
    with pytest.raises(NotImplementedError, match="unsupported image format"):
        image.read_image(str(q))


def test_resolve_search_order(tmp_path, monkeypatch):
    """$TPURAY_ASSET_ROOT first, then add_root (the newest first), then the
    built-in root; FileNotFoundError lists every path tried. The same order
    as tpuray's resolve."""
    env_root, added_old, added_new = (tmp_path / n for n in ("env", "old", "new"))
    for root, names in ((env_root, ["a"]), (added_old, ["a", "b", "c"]),
                        (added_new, ["a", "b"])):
        (root / "m").mkdir(parents=True)
        for name in names:
            (root / "m" / name).write_text(root.name)
    monkeypatch.setenv("TPURAY_ASSET_ROOT", str(env_root))
    monkeypatch.setattr(filesystem, "_extra_roots", [])
    monkeypatch.setattr(jfs, "_extra_roots", [])
    for fs in (filesystem, jfs):
        fs.add_root(added_new)
        fs.add_root(added_old)
        fs.add_root(added_new)  # re-adding moves a root to the front
    for name, root in (("a", env_root), ("b", added_new), ("c", added_old)):
        assert filesystem.resolve(f"m/{name}") == str(root / "m" / name)
        assert filesystem.resolve(f"m/{name}") == jfs.resolve(f"m/{name}")
    assert filesystem.roots()[:3] == jfs.roots()[:3]
    assert filesystem.roots()[-1] == os.path.join(ROOT, "assets")
    assert filesystem.resolve(str(env_root / "m" / "a")) == str(env_root / "m" / "a")
    with pytest.raises(FileNotFoundError, match="TPURAY_ASSET_ROOT") as e:
        filesystem.resolve("models/clock.obj")
    assert str(env_root / "models" / "clock.obj") in str(e.value)
    monkeypatch.delenv("TPURAY_ASSET_ROOT")
    assert filesystem.resolve("recovered_env.hdr") == os.path.join(
        ROOT, "assets", "recovered_env.hdr")


def _force_numpy(monkeypatch):
    def bvh_py(tv, leaf=8, force_py=False):
        return jbvh.build_bvh(tv, leaf, force_py=True)

    monkeypatch.setattr(jbuilder, "build_bvh", bvh_py)
    monkeypatch.setattr(jpart, "build_bvh", bvh_py)
    monkeypatch.setattr(jnative, "parse_obj_native", lambda *a: None)
    monkeypatch.setattr(jnative, "env_cache_native", lambda *a: None)
    monkeypatch.setattr(jnative, "read_bmp_native", lambda *a: None)
    monkeypatch.setattr(jnative, "read_hdr_native", lambda *a: None)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)  # the port's too


def _grid_obj(path, n=60):
    """An n x n grid of quads (2 n^2 triangles) with planar texcoords."""
    ys, xs = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    v = np.stack([xs.ravel() / n, 0.1 * np.sin(xs.ravel() * 0.7) * np.cos(ys.ravel()),
                  ys.ravel() / n], -1)
    q = (ys[:-1, :-1] * (n + 1) + xs[:-1, :-1]).ravel()
    faces = np.concatenate([np.stack([q, q + 1, q + n + 2], -1),
                            np.stack([q, q + n + 2, q + n + 1], -1)])
    obj.write_obj(path, v, faces, v[:, [0, 2]], faces)


@pytest.mark.parametrize("leaf,forest", [(8, False), (1, True)],
                         ids=["single_tree", "forest"])
def test_build_scene_matches(tmp_path, monkeypatch, leaf, forest):
    """Two objects (the test scene with procedural textures, a 7,200-triangle
    grid with BMP and PNG texture files), lights and an HDR env map file:
    every array equal to tpuray's build_scene. Leaf size 8 keeps the single
    tree; leaf size 1 doubles the nodes past the layout rule, and both build
    the same chunked forest."""
    _force_numpy(monkeypatch)
    scene_obj, grid_obj = str(tmp_path / "s.obj"), str(tmp_path / "g.obj")
    write_test_scene_obj(scene_obj, subdiv=1)
    _grid_obj(grid_obj)
    rs = np.random.default_rng(9)
    layers = {}
    for k, ext in (("albedo", "bmp"), ("metallic", "png"), ("normal", "bmp"),
                   ("roughness", "png")):
        p = str(tmp_path / f"{k}.{ext}")
        img = rs.random((12, 10, 3)).astype(np.float32)
        (image.write_bmp if ext == "bmp" else image.write_png)(p, img)
        layers[k] = p
    env = str(tmp_path / "env.hdr")
    hdr.write_hdr(env, _hdr_image(8, h=16, w=32) + 0.1)

    def objects(mod):
        return [mod.ObjectSpec(path=scene_obj, material=dict(builder.DEFAULT_MATERIAL),
                               scale=(2.0, 2.0, 2.0)),
                mod.ObjectSpec(path=grid_obj, material=dict(roughness=0.3),
                               rotate_deg=(0.0, 30.0, 0.0), translate=(0.2, -0.1, 0.0),
                               smooth_normals=False, textures=layers)]

    kw = dict(point_lights=builder.DEFAULT_LIGHTS, envmap=env, leaf_size=leaf,
              texture_res=16, with_textures=True)
    scene = builder.build_scene(objects(builder), **kw)
    got = scene_to_numpy(scene)
    want = scene_to_numpy(jbuilder.build_scene(objects(jbuilder), **kw))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert bool(scene.bvh.chunk_nodes) == forest
    assert scene.textures.data.shape == (2, 4, 16, 16, 3)


@pytest.mark.parametrize("n_nodes,n_tris", [(0, 0), (1000, 15000), (3000, 15000),
                                            (20000, 1000), (20186, 0), (20187, 0)])
def test_layout_rule_matches(n_nodes, n_tris):
    assert builder.fits_single_tree(n_nodes, n_tris) == scene_fits_smem(n_nodes, n_tris)


def test_reference_scene_raises_without_the_asset(monkeypatch):
    monkeypatch.delenv("TPURAY_ASSET_ROOT", raising=False)
    with pytest.raises(FileNotFoundError, match="clock.obj"):
        builder.reference_default_scene()


def _state(rs, h=4, w=5):
    f = lambda *s: rs.random(s).astype(np.float32)  # noqa: E731
    return dict(illum_hist=f(h, w, 3), variance_hist=f(h, w), prev_normal=f(h, w, 3),
                prev_linear_z=f(h, w), moments=f(h, w, 2), history_len=f(h, w),
                accum_color=f(h, w, 3), taa_color=f(h, w, 3), prev_view_proj=f(4, 4))


def test_checkpoint_across_packages(tmp_path):
    """A FrameState saved by tpuray loads into the port, and the port's
    saves load into tpuray, field for field."""
    rs = np.random.default_rng(10)
    fields = _state(rs)
    a, b = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_frame_state(a, JFrameState(
        frame_idx=jnp.int32(7), **{k: jnp.asarray(v) for k, v in fields.items()}))
    st = checkpoint.load_frame_state(a)
    assert isinstance(st, FrameState) and st.frame_idx == 7
    for k, v in fields.items():
        np.testing.assert_array_equal(getattr(st, k).numpy(), v, err_msg=k)
    checkpoint.save_frame_state(b, st.replace(frame_idx=9))
    back = jckpt.load_frame_state(b)
    assert int(back.frame_idx) == 9 and back.frame_idx.dtype == jnp.int32
    for k, v in fields.items():
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), v, err_msg=k)
    assert sorted(np.load(a).files) == sorted(np.load(b).files)


def test_frame_metrics_summary():
    ours, ref = FrameMetrics(64, 32, 2), JFrameMetrics(64, 32, 2)
    assert ours.summary() == ref.summary() == "{}"
    for s in (0.5, 0.031, 0.029, 0.0305):
        ours.record(s)
        ref.record(s)
    assert ours.summary() == ref.summary()
