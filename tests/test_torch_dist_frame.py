"""The port's fully sharded frame (tpuray_torch/dist/frame.py) on the CPU:
1, 2 and 4 gloo ranks against the port's single-device frame and against
tpuray's sharded frame, and each row-windowed denoise stage against its
tpuray function.

The ranks run as OS processes of `python -m tpuray_torch.dist.dryrun`
(dryrun.launch: a file store, one torch thread each, a hard timeout that
kills every rank's process group); rank 0 writes the gathered frames to
an npz that this file reads. A world of one runs in this process with no
process group. Sizes: dryrun.CHECK_* (64x64, depth 1, two a-trous
iterations, make_test_scene(subdiv=1, env_width=32), halo 8).

- compact_frac=0: the sharded frames are bit-equal to render_frame
  (pallas_denoise=False: the plain stages, which the sharded frame runs)
  at every world size, two moving frames and a still one: final,
  pt_color and the state (history_len included).
- compact_frac=0.5: each rank budgets its own hits, so the frames may
  differ from the single-device frame by the grazing-shadow outliers of
  tests/test_dist_frame.py (its image tolerance); mesh 2 against mesh 4
  alike, bit-equal at compact_frac=0.
- against tpuray's render_frame_sharded on a JAX mesh of 4: the still
  frame with the image tolerance of tests/test_torch_frame.py (XLA's FMAs
  move a few grazing shadow tests); the moving frames with the divergence
  of the history read as well: tpuray's sharded frame reads the moving
  camera's history through the tile-windowed fetch, which drops taps at
  motion discontinuities and the border, the port reads it exactly. In
  the second moving frame 3.25% of the pixels differ by more than 5e-4
  (133 of 4,096, 127 of them inside the image's 2-pixel border: motion
  discontinuities), at most by 0.606; tpuray's own single-device frame
  (the exact read, its CPU default) differs from its sharded one on the
  same pixels, and the port's sharded frame matches that single-device
  frame with the image tolerance. Bound: MOVING_FRAC, MOVING_MAX.
- the row-windowed stages on a halo-extended slab of a 32x48 image (row0
  8 and -4, the latter with replicated edge rows as rank 0 holds them):
  inside_mask exact, estimate_variance, atrous_iteration and the static
  reproject within rtol/atol 2e-5 of tpuray's (tests/test_torch_denoise.py),
  TAA within its tolerance; the port's moving reproject against its own
  full-image result bit for bit where the slab holds every tap, and
  against tpuray's tile-windowed one on the slab's interior.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tpuray.scene.procedural as jproc
from tpuray.denoise import atrous as jatrous
from tpuray.denoise import common as jcommon
from tpuray.denoise import reproject as jreproject
from tpuray.denoise import taa as jtaa
from tpuray.denoise import variance as jvariance
from tpuray.dist.frame import render_frame_sharded as j_render_frame_sharded
from tpuray.dist.frame import shard_state as j_shard_state
from tpuray.dist.sharding import make_mesh as j_make_mesh
from tpuray.render.frame_state import FrameState as JFrameState
from tpuray.render.renderer import render_frame as j_render_frame
from tpuray.scene.camera import OrbitCamera as JOrbitCamera
from tpuray.scene.config import RenderConfig as JRenderConfig

from tpuray_torch.denoise import atrous, common, reproject, taa, variance
from tpuray_torch.dist import dryrun
from tpuray_torch.dist.frame import (
    STATE_IMG_FIELDS, _halo_rows, render_frame_sharded, shard_state)
from tpuray_torch.dist.sharding import make_mesh
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.render.renderer import render_frame
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig

from tests.test_torch_denoise import _motion, gbuffer_arrays, reproject_arrays

torch.set_num_threads(2)

N = dryrun.CHECK_SIZE
MOVING_FRAC = 0.04  # the tile-windowed read's divergence, measured 0.0325
MOVING_MAX = 1.0    # measured 0.606
RTOL = ATOL = 2e-5


def assert_images_close(a, b, tol=5e-4, outlier_frac=0.005, outlier_max=0.1,
                        msg=""):
    """tests/test_dist_frame.py's image tolerance."""
    d = np.abs(np.asarray(a) - np.asarray(b)).max(-1)
    frac = float((d > tol).mean())
    assert frac <= outlier_frac, f"{msg}: {frac:.4%} pixels differ > {tol}"
    assert d.max() < outlier_max, f"{msg}: max diff {d.max():.4f}"


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{world size: check_job's frames}, worlds 2 and 4 launched at once."""
    d = tmp_path_factory.mktemp("dist_frame")
    out = {n: str(d / f"w{n}.npz") for n in (1, 2, 4)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(dryrun.launch, n, "cpu", out[n], ("frames",), 240.0)
                for n in (2, 4)]
        dryrun.check_job(make_mesh("cpu"), out[1], ("frames",))
        for r in runs:
            r.result()
    return {n: dict(np.load(p)) for n, p in out.items()}


def _single(cfg, rotations, static_last=False):
    """render_frame over the same camera path -> (outputs, last state)."""
    scene = dryrun.check_scene("cpu")
    cam = OrbitCamera(width=N, height=N)
    state = FrameState.initial(N, N)
    outs = []
    for i, rot in enumerate(rotations):
        still = static_last and i == len(rotations) - 1
        cam.rotate(0.0 if still else rot, 0.0)
        state, out = render_frame(scene, cam.snapshot(), state, cfg, N, N,
                                  static_camera=still)
        outs.append(out)
    return outs, state


@pytest.fixture(scope="module")
def single():
    cfg = RenderConfig(width=N, height=N, **dryrun.CHECK_CFG)
    with torch.no_grad():
        moving, state = _single(cfg, dryrun.CHECK_ROTATIONS)
        still, _ = _single(cfg, (0.0, 0.0), static_last=True)
        compact, _ = _single(dataclasses.replace(cfg, compact_frac=dryrun.CHECK_COMPACT),
                             dryrun.CHECK_ROTATIONS)
    return dict(moving=moving, state=state, still=still, compact=compact)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_frames_bit_equal_single(sharded, single, world):
    z = sharded[world]
    assert int(z["world"]) == world
    for i, out in enumerate(single["moving"]):
        np.testing.assert_array_equal(z[f"moving_final_{i}"], out.final.numpy(),
                                      err_msg=f"frame {i} final")
        np.testing.assert_array_equal(z[f"moving_pt_{i}"], out.pt_color.numpy(),
                                      err_msg=f"frame {i} pt_color")
    for field in ("history_len", "illum_hist", "moments", "taa_color"):
        np.testing.assert_array_equal(z[f"moving_state_{field}"],
                                      getattr(single["state"], field).numpy(),
                                      err_msg=field)
    assert z["moving_state_history_len"].max() == 2.0  # the history carried over
    np.testing.assert_array_equal(z["static_final_1"], single["still"][1].final.numpy())


@pytest.mark.parametrize("world", [1, 2, 4])
def test_compacted_sharded_frames(sharded, single, world):
    for i, out in enumerate(single["compact"]):
        got = sharded[world][f"compact_final_{i}"]
        assert np.isfinite(got).all()
        assert_images_close(got, out.final.numpy(), msg=f"world {world} frame {i}")


def test_mesh_2_vs_4(sharded):
    two, four = sharded[2], sharded[4]
    for key in two:
        if key.startswith(("moving_", "static_")):
            np.testing.assert_array_equal(two[key], four[key], err_msg=key)
        elif key.startswith("compact_"):
            assert_images_close(two[key], four[key], msg=key)


@pytest.fixture(scope="module")
def tpuray_frames():
    """tpuray's render_frame_sharded on a JAX mesh of 4 (both packages'
    native BVH builds are the same tree at this size): the moving frames,
    and the still frame after a first one; and tpuray's single-device
    render_frame over the moving frames (the exact history read)."""
    scene = jproc.make_test_scene(**dryrun.CHECK_SCENE)
    cfg = JRenderConfig(width=N, height=N, **dryrun.CHECK_CFG)
    mesh = j_make_mesh(4)

    def run(rotations, static_last=False):
        cam = JOrbitCamera(width=N, height=N)
        state = j_shard_state(JFrameState.initial(N, N), mesh)
        finals = []
        for i, rot in enumerate(rotations):
            still = static_last and i == len(rotations) - 1
            cam.rotate(0.0 if still else rot, 0.0)
            state, final, _ = j_render_frame_sharded(
                scene, cam.snapshot(), state, cfg, N, N, mesh,
                halo=dryrun.CHECK_HALO, static_camera=still)
            finals.append(np.asarray(final))
        return finals

    cam = JOrbitCamera(width=N, height=N)
    state = JFrameState.initial(N, N)
    exact = []
    for rot in dryrun.CHECK_ROTATIONS:
        cam.rotate(rot, 0.0)
        state, out = j_render_frame(scene, cam.snapshot(), state, cfg, N, N)
        exact.append(np.asarray(out.final))
    return dict(moving=run(dryrun.CHECK_ROTATIONS),
                still=run((0.0, 0.0), static_last=True), exact=exact)


def test_still_frame_matches_tpuray(sharded, tpuray_frames):
    assert_images_close(sharded[4]["static_final_1"], tpuray_frames["still"][1],
                        msg="still frame, port vs tpuray")


def test_moving_frames_match_tpuray(sharded, tpuray_frames):
    """Frame 0 has no history: the image tolerance. Frame 1 reads the
    history: within the image tolerance of tpuray's exact read, and within
    the tile-windowed read's divergence of tpuray's sharded frame, on the
    pixels where tpuray's two reads differ."""
    port = [sharded[4][f"moving_final_{i}"] for i in range(2)]
    assert_images_close(port[0], tpuray_frames["moving"][0], msg="frame 0, port vs tpuray")
    assert_images_close(port[1], tpuray_frames["exact"][1],
                        msg="frame 1, port vs tpuray's single-device frame")
    d = np.abs(port[1] - tpuray_frames["moving"][1]).max(-1)
    frac = float((d > 5e-4).mean())
    print(f"moving frame 1, port (exact read) vs tpuray's sharded frame (tile-windowed "
          f"read): {frac:.4%} of pixels beyond 5e-4, max |diff| {d.max():.4g}")
    assert frac <= MOVING_FRAC and d.max() < MOVING_MAX
    tpuray_own = np.abs(tpuray_frames["exact"][1] - tpuray_frames["moving"][1]).max(-1)
    assert ((d > 5e-4) <= (tpuray_own > 1e-4)).all()


# ---- the row-windowed stages


H, W = 32, 48
WINDOWS = [(8, 16), (-4, 16), (20, 16)]  # (row0, rows) of the extended slab


def _slab(a, row0, rows):
    """Rows row0 .. row0 + rows - 1 of a full-image array, the image's edge
    rows replicated past its border (what _halo_rows gives rank 0 and the
    last rank)."""
    idx = np.clip(np.arange(row0, row0 + rows), 0, a.shape[0] - 1)
    return np.ascontiguousarray(a[idx])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, name, where=slice(None)):
    np.testing.assert_allclose(np.asarray(got)[where], np.asarray(ref)[where],
                               rtol=RTOL, atol=ATOL, err_msg=name)


def _inner(row0, rows, top, bottom):
    """The slab rows that are image rows and at least `top` rows below the
    slab's first row and `bottom` above its last: there a stencil reads
    only the rows the shard really holds."""
    g = np.arange(row0, row0 + rows)
    i = np.arange(rows)
    return (g >= 0) & (g < H) & (i >= top) & (i < rows - bottom)


def _full_rows(x, row0, rows):
    return x.numpy()[np.clip(np.arange(row0, row0 + rows), 0, H - 1)]


@pytest.mark.parametrize("row0", [-4, 0, 8, 28])
@pytest.mark.parametrize("dy,dx", [(-3, 0), (2, -1), (0, 3), (-6, 4)])
def test_inside_mask_row_window(row0, dy, dx):
    got = common.inside_mask((16, W), dy, dx, row_window=(row0, H))
    ref = jcommon.inside_mask((16, W), dy, dx, row_window=(row0, H))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("row0,rows", WINDOWS)
def test_estimate_variance_row_window(row0, rows):
    rng = np.random.default_rng(7)
    g = gbuffer_arrays(rng, H, W, sky_rows=3)
    a = dict(illum=rng.random((H, W, 3)).astype(np.float32),
             variance=rng.random((H, W)).astype(np.float32),
             moments=rng.random((H, W, 2)).astype(np.float32),
             history_len=np.floor(rng.random((H, W)) * 6).astype(np.float32),
             normal=g["normal"], linear_z=g["linear_z"], fwidth_z=g["fwidth_z"])
    s = {k: _slab(v, row0, rows) for k, v in a.items()}
    win = (row0, H)
    got = variance.estimate_variance(**{k: _t(v) for k, v in s.items()},
                                     cfg=RenderConfig(), row_window=win)
    ref = jvariance.estimate_variance(**{k: jnp.asarray(v) for k, v in s.items()},
                                      cfg=JRenderConfig(), row_window=win)
    full = variance.estimate_variance(**{k: _t(v) for k, v in a.items()}, cfg=RenderConfig())
    inner = _inner(row0, rows, 3, 3)
    for f in ("illum", "variance"):
        _close(getattr(got, f), getattr(ref, f), f)
        np.testing.assert_array_equal(getattr(got, f).numpy()[inner],
                                      _full_rows(getattr(full, f), row0, rows)[inner],
                                      err_msg=f)


@pytest.mark.parametrize("row0,rows", WINDOWS)
@pytest.mark.parametrize("step", [1, 2])
def test_atrous_iteration_row_window(row0, rows, step):
    rng = np.random.default_rng(11 + step)
    g = gbuffer_arrays(rng, H, W, sky_rows=2)
    args = [rng.random((H, W, 3)).astype(np.float32),
            rng.random((H, W)).astype(np.float32),
            g["normal"], g["linear_z"], g["fwidth_z"]]
    s = [_slab(x, row0, rows) for x in args]
    win = (row0, H)
    gi, gv = atrous.atrous_iteration(*map(_t, s), step=step, cfg=RenderConfig(),
                                     row_window=win)
    ri, rv = jatrous.atrous_iteration(*map(jnp.asarray, s), step=step,
                                      cfg=JRenderConfig(), row_window=win)
    _close(gi, ri, "illum")
    _close(gv, rv, "variance")
    fi, fv = atrous.atrous_iteration(*map(_t, args), step=step, cfg=RenderConfig())
    inner = _inner(row0, rows, 2 * step + 1, 2 * step + 1)
    for got, full in ((gi, fi), (gv, fv)):
        np.testing.assert_array_equal(got.numpy()[inner],
                                      _full_rows(full, row0, rows)[inner])


def _reproject_inputs(rng, motion):
    a = reproject_arrays(rng, motion, H, W,
                         hist=np.floor(rng.random((H, W)) * 6))
    a["prev_linear_z"][10:14, 4:20] += 5.0  # a rescued block
    return a


@pytest.mark.parametrize("row0,rows", WINDOWS)
def test_reproject_static_row_window(row0, rows):
    rng = np.random.default_rng(31)
    a = _reproject_inputs(rng, np.zeros((H, W, 2)))
    s = {k: _slab(v, row0, rows) for k, v in a.items()}
    win = (row0, H)
    got = reproject.reproject(**{k: _t(v) for k, v in s.items()}, cfg=RenderConfig(),
                              static_camera=True, row_window=win)
    ref = jreproject.reproject(**{k: jnp.asarray(v) for k, v in s.items()},
                               cfg=JRenderConfig(), static_camera=True, row_window=win)
    for f in got._fields:
        _close(getattr(got, f), getattr(ref, f), f)


@pytest.mark.parametrize("row0,rows", WINDOWS)
def test_reproject_moving_row_window(row0, rows):
    """History (2.25, 1.5) pixels right of and below each pixel: the taps of
    a pixel on row y span rows y .. y + 3. Where they lie inside the slab
    the port equals its full-image result bit for bit, and tpuray's
    tile-windowed read within rtol 2e-5 away from the right and bottom
    borders (there the exact read clamps its rescue quads into the image
    and counts an edge tap twice, the tile-windowed read drops the taps past
    the image); a pixel whose taps leave the slab fails its reprojection
    (history_len 1)."""
    rng = np.random.default_rng(41)
    a = _reproject_inputs(rng, _motion(-2.25, -1.5, H, W))
    s = {k: _slab(v, row0, rows) for k, v in a.items()}
    win = (row0, H)
    got = reproject.reproject(**{k: _t(v) for k, v in s.items()}, cfg=RenderConfig(),
                              row_window=win)
    full = reproject.reproject(**{k: _t(v) for k, v in a.items()}, cfg=RenderConfig())
    inner = _inner(row0, rows, 0, 3)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy()[inner],
                                      _full_rows(getattr(full, f), row0, rows)[inner],
                                      err_msg=f)
    if row0 + rows + 3 < H:  # the last row's taps lie below the slab
        np.testing.assert_array_equal(got.history_len.numpy()[rows - 1], 1.0)
    ref = jreproject.reproject(**{k: jnp.asarray(v) for k, v in s.items()},
                               cfg=JRenderConfig(reproject_gather="tiled"),
                               row_window=win)
    off_border = inner & (np.arange(row0, row0 + rows) < H - 4)
    for f in got._fields:
        _close(getattr(got, f), getattr(ref, f), f, where=(off_border, slice(0, W - 4)))


@pytest.mark.parametrize("row0,rows", WINDOWS)
@pytest.mark.parametrize("static", [False, True])
def test_taa_row_window(row0, rows, static):
    """The moving history fetch of (1.5, 0.75) pixels: inside the slab the
    port's clamped bilinear read equals tpuray's tile-windowed one; the
    first slab row reads above it and takes the current color (blend 1),
    as tpuray's hist_ok does."""
    rng = np.random.default_rng(51)
    g = gbuffer_arrays(rng, H, W)
    a = dict(cur_color=rng.random((H, W, 3)).astype(np.float32),
             prev_color=rng.random((H, W, 3)).astype(np.float32),
             velocity=_motion(1.5, 0.75, H, W), linear_z=g["linear_z"])
    s = {k: _slab(v, row0, rows) for k, v in a.items()}
    win = (row0, H)
    got = taa.taa(**{k: _t(v) for k, v in s.items()}, frame=3, static_camera=static,
                  row_window=win)
    ref = jtaa.taa(**{k: jnp.asarray(v) for k, v in s.items()}, frame=3,
                   static_camera=static, tiled_fetch=not static, row_window=win)
    # away from the left border, where tpuray's fetch drops the taps past
    # the image and the port's clamps them to column 0
    where = (_inner(row0, rows, 2, 2), slice(2, W))
    np.testing.assert_allclose(got.numpy()[where], np.asarray(ref)[where],
                               rtol=1e-4, atol=1e-5)
    if not static and row0 > 0:
        # row 0 reads the history row above the slab: no history
        np.testing.assert_allclose(got.numpy()[0], s["cur_color"][0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [1, 3])
def test_halo_rows_world_of_one(k):
    """A world of one replicates its edge rows, as shift2d clamps."""
    rng = np.random.default_rng(3)
    x = _t(rng.random((6, 5, 3)).astype(np.float32))
    y = _t(rng.random((6, 5)).astype(np.float32))
    ex, ey = _halo_rows(make_mesh("cpu"), k, x, y)
    idx = np.clip(np.arange(-k, 6 + k), 0, 5)
    np.testing.assert_array_equal(ex.numpy(), x.numpy()[idx])
    np.testing.assert_array_equal(ey.numpy(), y.numpy()[idx])


def test_layout_checks():
    mesh = make_mesh("cpu")
    cfg = RenderConfig(width=16, height=16, num_atrous_iterations=3)
    state = shard_state(FrameState.initial(16, 16), mesh)
    assert set(STATE_IMG_FIELDS) <= {f.name for f in dataclasses.fields(state)}
    with pytest.raises(ValueError, match="halo"):
        render_frame_sharded(dryrun.check_scene("cpu"), OrbitCamera(width=16, height=16)
                             .snapshot(), state, cfg, 16, 16, mesh, halo=4)


def test_kernel_denoiser_refused():
    """The sharded frame runs the plain denoise stages (K4 and K5 take no
    row window), so a config that asks for the kernels raises; with SVGF
    off no denoiser runs and the config is taken."""
    mesh = make_mesh("cpu")
    cfg = RenderConfig(width=16, height=16, max_tracing_depth=1, num_atrous_iterations=2)
    assert cfg.pallas_denoise
    scene = dryrun.check_scene("cpu")
    cam = OrbitCamera(width=16, height=16).snapshot()
    state = shard_state(FrameState.initial(16, 16), mesh)
    with pytest.raises(ValueError, match="pallas_denoise=False"):
        render_frame_sharded(scene, cam, state, cfg, 16, 16, mesh, halo=8)
    with torch.no_grad():
        _, final, pt_color = render_frame_sharded(
            scene, cam, state, dataclasses.replace(cfg, enable_svgf=False), 16, 16, mesh,
            halo=8)
    assert torch.equal(final, pt_color)
