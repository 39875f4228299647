"""The port's fully sharded frame (tpuray_torch/dist/frame.py) on the CPU:
1, 2 and 4 gloo ranks against the port's single-device frame and against
tpuray's sharded frame, under each denoiser (pallas_denoise True: K4 and
K5, here their plain versions; False: the plain stages), and each
row-windowed denoise stage against its tpuray function.

The ranks run as OS processes of `python -m tpuray_torch.dist.dryrun`
(dryrun.launch: a file store, one torch thread each, a hard timeout that
kills every rank's process group); rank 0 writes the gathered frames to
an npz that this file reads. A world of one runs in this process with no
process group. Sizes: dryrun.CHECK_* (64x64, depth 1, two a-trous
iterations, make_test_scene(subdiv=1, env_width=32), halo 8).

- compact_frac=0: the sharded frames are bit-equal to render_frame under
  the same denoiser at every world size, two moving frames and a still
  one: final, pt_color and the state (history_len included). The kernel
  denoiser's K4 reprojects the 3 rows past a shard's edges itself, on rows
  extended by halo + 3, where the plain stages take them from the
  neighbour: the same frame wherever the history taps stay inside the halo.
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
  8, -4 and 20, -4 with replicated edge rows as rank 0 holds them):
  inside_mask exact, estimate_variance, atrous_iteration and the static
  reproject within rtol/atol 2e-5 of tpuray's (tests/test_torch_denoise.py),
  TAA within its tolerance; the port's moving reproject against its own
  full-image result bit for bit where the slab holds every tap, and
  against tpuray's tile-windowed one on the slab's interior; K4's and K5's
  wrappers (kernels/reproject.py, kernels/atrous.py:atrous_step) with a
  row window against reproject + estimate_variance and atrous_iteration
  composed on the same slab (exact) and against the whole image where every
  tap lies inside; and a motion larger than the halo: K4's path fails its
  reprojection exactly where its plain version does, at the pixels whose
  taps leave its rows, and differs from the plain stages' sharded frame
  only where the taps travel farther than the halo.
- the shared pieces of the frame, with ranks emulated in this process
  (a Mesh with no process group, so SVGF, which exchanges rows, stays off
  past a world of one): dist/sharding.py:trace_rows bit-equal to
  render_tiled's images, to the split frame's pt_color and to
  render_frame's rows; and the hook the benchmark reads the split frame's
  G-buffer and denoiser outputs through (portbench/sharded.py): a
  pass-through in place of dist.frame.denoise_and_advance is called once a
  frame with a G-buffer of the shard's rows and changes nothing.
"""
import concurrent.futures
import dataclasses
import inspect

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
from tpuray_torch.kernels import atrous as katrous
from tpuray_torch.kernels import reproject as kreproject
from tpuray_torch.dist.frame import (
    STATE_IMG_FIELDS, _halo_rows, render_frame_sharded, shard_state)
from tpuray_torch.dist.sharding import Mesh, make_mesh, render_tiled, trace_rows
from tpuray_torch.integrator.gbuffer import GBuffer
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.render.renderer import render_frame
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig

from tests.test_torch_denoise import _motion, gbuffer_arrays, reproject_arrays
from tests.test_torch_denoise_tiles import _sharded_stage, _slab

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
    """{world size: check_job's frames}, worlds 2 and 4 launched at once;
    world 4 also renders the moving frames under the tiled read."""
    d = tmp_path_factory.mktemp("dist_frame")
    out = {n: str(d / f"w{n}.npz") for n in (1, 2, 4)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(dryrun.launch, n, "cpu", out[n],
                            ("frames", "tiled_read") if n == 4 else ("frames",), 240.0)
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
    """{denoiser: render_frame's frames under it} (dryrun.DENOISERS)."""
    res = {}
    for den, pallas in dryrun.DENOISERS.items():
        cfg = RenderConfig(width=N, height=N, pallas_denoise=pallas, **dryrun.CHECK_CFG)
        with torch.no_grad():
            moving, state = _single(cfg, dryrun.CHECK_ROTATIONS)
            still, _ = _single(cfg, (0.0, 0.0), static_last=True)
            compact, _ = _single(dataclasses.replace(cfg, compact_frac=dryrun.CHECK_COMPACT),
                                 dryrun.CHECK_ROTATIONS)
        res[den] = dict(moving=moving, state=state, still=still, compact=compact)
    return res


DENOISERS = list(dryrun.DENOISERS)


def _assert_bit_equal_single(z, single, den):
    """The world's moving and still frames under denoiser `den` bit-equal
    to render_frame's."""
    ref = single[den]
    for i, out in enumerate(ref["moving"]):
        np.testing.assert_array_equal(z[f"{den}_moving_final_{i}"], out.final.numpy(),
                                      err_msg=f"frame {i} final")
        np.testing.assert_array_equal(z[f"{den}_moving_pt_{i}"], out.pt_color.numpy(),
                                      err_msg=f"frame {i} pt_color")
    for field in ("history_len", "illum_hist", "moments", "taa_color"):
        np.testing.assert_array_equal(z[f"{den}_moving_state_{field}"],
                                      getattr(ref["state"], field).numpy(),
                                      err_msg=field)
    assert z[f"{den}_moving_state_history_len"].max() == 2.0  # the history carried over
    np.testing.assert_array_equal(z[f"{den}_static_final_1"], ref["still"][1].final.numpy())


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_frames_bit_equal_single(sharded, single, world):
    """The plain stages (pallas_denoise=False)."""
    assert int(sharded[world]["world"]) == world
    _assert_bit_equal_single(sharded[world], single, "plain")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_kernel_denoiser_sharded(sharded, single, world):
    """RenderConfig()'s denoiser, K4 once on each rank's rows and K5 once
    an iteration (their plain versions here), equals render_frame under
    the same config bit for bit; with SVGF off no denoiser runs."""
    assert int(sharded[world]["world"]) == world
    _assert_bit_equal_single(sharded[world], single, "kernels")
    if world == 1:
        mesh = make_mesh("cpu")
        cfg = RenderConfig(width=16, height=16, max_tracing_depth=1, num_atrous_iterations=2,
                           enable_svgf=False)
        state = shard_state(FrameState.initial(16, 16), mesh)
        with torch.no_grad():
            _, final, pt_color = render_frame_sharded(
                dryrun.check_scene("cpu"), OrbitCamera(width=16, height=16).snapshot(),
                state, cfg, 16, 16, mesh, halo=8)
        assert torch.equal(final, pt_color)


@pytest.mark.parametrize("den", DENOISERS)
@pytest.mark.parametrize("world", [1, 2, 4])
def test_compacted_sharded_frames(sharded, single, world, den):
    for i, out in enumerate(single[den]["compact"]):
        got = sharded[world][f"{den}_compact_final_{i}"]
        assert np.isfinite(got).all()
        assert_images_close(got, out.final.numpy(), msg=f"world {world} frame {i}")


@pytest.mark.parametrize("den", DENOISERS)
def test_mesh_2_vs_4(sharded, den):
    two, four = sharded[2], sharded[4]
    for key in two:
        if key.startswith((f"{den}_moving_", f"{den}_static_")):
            np.testing.assert_array_equal(two[key], four[key], err_msg=key)
        elif key.startswith(f"{den}_compact_"):
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


@pytest.mark.parametrize("den", DENOISERS)
def test_still_frame_matches_tpuray(sharded, tpuray_frames, den):
    assert_images_close(sharded[4][f"{den}_static_final_1"], tpuray_frames["still"][1],
                        msg="still frame, port vs tpuray")


@pytest.mark.parametrize("den", DENOISERS + [f"{d}_tiled_read" for d in DENOISERS])
def test_moving_frames_match_tpuray(sharded, tpuray_frames, den):
    """Frame 0 has no history: the image tolerance. Frame 1 reads the
    history: within the image tolerance of tpuray's exact read, and within
    the tile-windowed read's divergence of tpuray's sharded frame, on the
    pixels where tpuray's two reads differ. tpuray's config is the port's:
    its sharded frame denoises with XLA's stencils either way.
    *_tiled_read: the port's sharded frame under reproject_gather="tiled"
    reads as tpuray's sharded frame does: both moving frames within the
    image tolerance of tpuray's."""
    if den.endswith("_tiled_read"):
        for i in range(2):
            assert_images_close(sharded[4][f"{den}_moving_final_{i}"],
                                tpuray_frames["moving"][i],
                                msg=f"frame {i}, port (tiled read) vs tpuray's sharded frame")
        assert sharded[4][f"{den}_moving_state_history_len"].max() == 2.0
        return
    port = [sharded[4][f"{den}_moving_final_{i}"] for i in range(2)]
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


@pytest.mark.parametrize("row0,rows", WINDOWS)
def test_k4_row_window(row0, rows):
    """K4's wrapper with a row window (its plain version on the CPU, no
    launch) is reproject + estimate_variance composed on the same slab with
    the same window, exactly; and the whole image's K4 bit for bit on the
    rows whose 7x7 fallback reads only reprojections whose taps lie in the
    slab (the taps of row y span rows y .. y + 3)."""
    rng = np.random.default_rng(61)
    a = _reproject_inputs(rng, _motion(-2.25, -1.5, H, W))
    s = {k: _t(_slab(v, row0, rows)) for k, v in a.items()}
    win, cfg = (row0, H), RenderConfig()
    kreproject.reset_launches()
    got = kreproject.reproject_variance_fused(cfg, row_window=win, **s)
    assert kreproject.LAUNCHES["k4"] == 0
    rep = reproject.reproject(**s, cfg=cfg, row_window=win)
    var = variance.estimate_variance(rep.illum, rep.variance, rep.moments, rep.history_len,
                                     s["normal"], s["linear_z"], s["fwidth_z"], cfg,
                                     row_window=win)
    composed = dict(rep_illum=rep.illum, rep_variance=rep.variance, var_illum=var.illum,
                    var_variance=var.variance, moments=rep.moments,
                    history_len=rep.history_len)
    for f in got._fields:
        assert torch.equal(getattr(got, f), composed[f]), f
    full = kreproject.reproject_variance_fused(cfg, **{k: _t(v) for k, v in a.items()})
    inner = _inner(row0, rows, 3, 6)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy()[inner],
                                      _full_rows(getattr(full, f), row0, rows)[inner],
                                      err_msg=f)
    assert (got.history_len.numpy()[inner] < 4).any()  # the fallback ran there


@pytest.mark.parametrize("row0,rows", WINDOWS[:2])
@pytest.mark.parametrize("step", [1, 2])
def test_k5_step_row_window(row0, rows, step):
    """K5's one-iteration wrapper with a row window (its plain version on
    the CPU, no launch) is atrous_iteration with that window, exactly, and
    the whole image's iteration bit for bit 2 * step + 1 rows in."""
    rng = np.random.default_rng(71 + step)
    g = gbuffer_arrays(rng, H, W, sky_rows=2)
    args = [rng.random((H, W, 3)).astype(np.float32),
            rng.random((H, W)).astype(np.float32),
            g["normal"], g["linear_z"], g["fwidth_z"]]
    s = [_t(_slab(x, row0, rows)) for x in args]
    win, cfg = (row0, H), RenderConfig()
    katrous.reset_launches()
    got = katrous.atrous_step(*s, step, cfg, row_window=win)
    assert katrous.LAUNCHES["k5"] == 0
    ref = atrous.atrous_iteration(*s, step=step, cfg=cfg, row_window=win)
    full = katrous.atrous_step(*map(_t, args), step, cfg)
    inner = _inner(row0, rows, 2 * step + 1, 2 * step + 1)
    for a, b, f in zip(got, ref, full):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy()[inner], _full_rows(f, row0, rows)[inner])


def test_k4_motion_beyond_the_halo():
    """History 6.5 rows below every pixel, 2 shards of 16 rows, halo 4: the
    taps of row y span rows y + 5 .. y + 8 (rescue included). The kernel
    path (K4 on each shard's rows extended by halo + 3, then cropped, as
    svgf_pipeline runs it) fails its reprojection exactly where its plain
    version (reproject + estimate_variance composed on those rows) does,
    and beyond the whole image's failures exactly on shard 0's last row,
    whose taps reach row 23, past the 23 rows the shard extends to. The
    plain stages' sharded frame (reproject on the shard extended by the
    halo, the fallback's 3 rows from the neighbour) also fails rows 12-14,
    whose taps reach rows 20-22; the two differ there and on the fallback
    pixels within 3 rows of them (rows 9-18), nowhere else."""
    halo, cfg = 4, RenderConfig()
    rng = np.random.default_rng(81)
    # a history of 1 to 5 frames: history_len 1 marks a failed reprojection
    a = reproject_arrays(rng, _motion(0.25, -6.5, H, W), H, W,
                         hist=1 + np.floor(rng.random((H, W)) * 5))
    names = kreproject.INPUT_NAMES

    def k4(s, win):
        return tuple(kreproject.reproject_variance_fused(cfg, row_window=win, **s))

    def composed(s, win):
        rep = reproject.reproject(**s, cfg=cfg, row_window=win)
        var = variance.estimate_variance(rep.illum, rep.variance, rep.moments,
                                         rep.history_len, s["normal"], s["linear_z"],
                                         s["fwidth_z"], cfg, row_window=win)
        return (rep.illum, rep.variance, var.illum, var.variance, rep.moments,
                rep.history_len)

    ta = {n: _t(v) for n, v in a.items()}
    kern = _sharded_stage(k4, ta, 2, halo + 3)
    plain = _sharded_stage(composed, ta, 2, halo + 3)
    for x, y, f in zip(kern, plain, kreproject.FusedOutput._fields):
        assert torch.equal(x, y), f
    hl = kern[-1].numpy()
    whole = kreproject.reproject_variance_fused(cfg, **{n: _t(a[n]) for n in names})
    hl_whole = whole.history_len.numpy()
    assert ((hl_whole == 1) <= (hl == 1)).all()
    extra = np.nonzero(((hl == 1) & (hl_whole != 1)).any(1))[0]
    np.testing.assert_array_equal(extra, [15])

    # the plain stages' sharded frame: the reprojection on the shard and its
    # halo, the variance fallback on the stitched reprojection
    rep = _sharded_stage(lambda s, win: tuple(reproject.reproject(**s, cfg=cfg,
                                                                  row_window=win)),
                         ta, 2, halo)
    var = variance.estimate_variance(*rep, _t(a["normal"]), _t(a["linear_z"]),
                                     _t(a["fwidth_z"]), cfg)
    np.testing.assert_array_equal(
        np.nonzero((rep[3].numpy() != hl).any(1))[0], [12, 13, 14])
    assert (rep[3].numpy()[12:15] == 1).all() and (hl[12:15] > 1).all()
    differs = (var.illum != kern[2]).any(-1) | (var.variance != kern[3])
    rows = np.nonzero(differs.numpy().any(1))[0]
    assert len(rows) and rows.min() >= 9 and rows.max() <= 18, rows


def test_k4_tiled_shard_edges():
    """The tiled read on 2 shards of 16 rows, halo 4. A pixel's tiled read
    depends on the tiles of the stage that reads it, which start at the
    stage's first row. K4 (on the rows extended by the halo, as
    svgf_pipeline runs it under the tiled read) reprojects the 3 rows past
    its shard that its fallback reads in its own tiles; the plain stages
    take them from the neighbour, which reads them in its tiles. Rows 6-7
    hold history 5 rows up (a residual past the span of the other rows'
    0): they lower the window of shard 0's one tile (rows -4..19), so its
    rows do not resolve but for rows 6-7, while shard 1's tile (rows
    12..35) resolves its rows. The reprojections of the shards' own rows
    are equal (K4 and its plain version are the same function); the
    fallback differs on rows 13-15, which read rows 16-18 as shard 0
    reprojects them (failed, where shard 1 resolves them), and on rows
    16-18, which read rows 13-15 as shard 1 reprojects them (resolved,
    where shard 0 fails them); nowhere else."""
    halo, cfg = 4, RenderConfig(reproject_gather="tiled")
    rng = np.random.default_rng(91)
    yy = np.arange(H)[:, None] + np.zeros((1, W))
    a = reproject_arrays(rng, _motion(0.25, np.where((yy >= 6) & (yy < 8), 5.0, 0.0), H, W),
                         H, W, hist=1 + np.floor(rng.random((H, W)) * 2))
    ta = {n: _t(v) for n, v in a.items()}

    def k4(s, win):
        return tuple(kreproject.reproject_variance_fused(cfg, row_window=win, **s))

    kern = kreproject.FusedOutput(*_sharded_stage(k4, ta, 2, halo))
    rep = _sharded_stage(lambda s, win: tuple(reproject.reproject(**s, cfg=cfg,
                                                                  row_window=win)),
                         ta, 2, halo)
    var = variance.estimate_variance(*rep, _t(a["normal"]), _t(a["linear_z"]),
                                     _t(a["fwidth_z"]), cfg)
    for x, y in zip((kern.rep_illum, kern.rep_variance, kern.moments, kern.history_len), rep):
        assert torch.equal(x, y)
    hl = kern.history_len.numpy()
    assert (hl[:16][[0, 1, 2, 3, 4, 5, 8, 9, 10, 11]] == 1.0).all()  # shard 0: no window
    assert (hl[16:] > 1.0).mean() > 0.9                             # shard 1 resolves
    differs = (var.illum != kern.var_illum).any(-1) | (var.variance != kern.var_variance)
    np.testing.assert_array_equal(np.nonzero(differs.numpy().any(1))[0],
                                  [13, 14, 15, 16, 17, 18])


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


@pytest.mark.parametrize("pallas", [True, False])
def test_layout_holds_k4_reach(pallas):
    """K4 reads halo + 3 rows past a shard: a shard of 16 rows holds a halo
    of 14 for the plain stages, not for K4."""
    from tpuray_torch.dist.frame import _check_layout
    mesh = make_mesh("cpu")
    cfg = RenderConfig(width=16, height=16, num_atrous_iterations=3, pallas_denoise=pallas)
    assert _check_layout(16, mesh, cfg, halo=13) == 16
    if pallas:
        with pytest.raises(ValueError, match="K4's reach"):
            _check_layout(16, mesh, cfg, halo=14)
    else:
        assert _check_layout(16, mesh, cfg, halo=14) == 16


def _emulated_mesh(rank, world):
    """Rank `rank` of a world of `world` in this process: no process group,
    so past a world of one only a frame with SVGF off (no halo exchange)
    runs on it."""
    return Mesh(rank, world, torch.device("cpu"))


def _split_frames(mesh, cfg):
    """render_frame_sharded's frames over dryrun.CHECK_ROTATIONS on `mesh`
    -> [(final, pt_color, new state)]."""
    scene = dryrun.check_scene("cpu")
    cam = OrbitCamera(width=N, height=N)
    state = shard_state(FrameState.initial(N, N), mesh)
    outs = []
    with torch.no_grad():
        for rot in dryrun.CHECK_ROTATIONS:
            cam.rotate(rot, 0.0)
            state, final, pt_color = render_frame_sharded(
                scene, cam.snapshot(), state, cfg, N, N, mesh, halo=dryrun.CHECK_HALO)
            outs.append((final, pt_color, state))
    return outs


@pytest.mark.parametrize("world", [1, 2])
def test_denoiser_hook(monkeypatch, world):
    """The split frame calls dist.frame.denoise_and_advance, looked up at
    call time, once a frame, its gbuf a GBuffer of the shard's rows, and a
    pass-through there changes nothing (what portbench/sharded.py relies on
    to read a kept frame's stages). World 1 under the kernel denoiser;
    world 2's ranks emulated one after the other, SVGF off."""
    from tpuray_torch.dist import frame as dframe
    cfg = RenderConfig(width=N, height=N, enable_svgf=world == 1, **dryrun.CHECK_CFG)
    rows = N // world
    shapes = [(rows, N, 3), (rows, N), (rows, N, 2), (rows, N), (rows, N), (rows, N, 3)]
    for rank in range(world):
        mesh = _emulated_mesh(rank, world)
        plain = _split_frames(mesh, cfg)
        advance, seen = dframe.denoise_and_advance, []

        def passed(*a, **k):
            seen.append(inspect.signature(advance).bind(*a, **k).arguments["gbuf"])
            return advance(*a, **k)

        with monkeypatch.context() as m:
            m.setattr(dframe, "denoise_and_advance", passed)
            hooked = _split_frames(mesh, cfg)
        assert len(seen) == len(dryrun.CHECK_ROTATIONS)
        for gbuf in seen:
            assert isinstance(gbuf, GBuffer)
            assert [tuple(x.shape) for x in gbuf] == shapes
        for (f0, p0, s0), (f1, p1, s1) in zip(plain, hooked):
            assert torch.equal(f0, f1) and torch.equal(p0, p1)
            assert s0.frame_idx == s1.frame_idx
            for field in STATE_IMG_FIELDS + ("prev_view_proj",):
                assert torch.equal(getattr(s0, field), getattr(s1, field)), field


@pytest.mark.parametrize("world", [1, 2, 4])
def test_trace_rows_shared(world):
    """dist/sharding.py:trace_rows, each rank's rows of a moving frame,
    bit-equal to render_tiled's color, emission and albedo, to the split
    frame's pt_color under accumulate=False, and to render_frame's rows."""
    scene = dryrun.check_scene("cpu")
    cam = OrbitCamera(width=N, height=N)
    cam.rotate(1.5, 0.0)
    snap = cam.snapshot()
    cfg = RenderConfig(width=N, height=N, accumulate=False, enable_svgf=False,
                       **dryrun.CHECK_CFG)
    frame, rows = 1, N // world
    state = FrameState.initial(N, N).replace(frame_idx=frame)
    with torch.no_grad():
        _, whole = render_frame(scene, snap, state, cfg, N, N)
        for rank in range(world):
            mesh = _emulated_mesh(rank, world)
            pt = trace_rows(scene, snap, cfg, N, N, rank * rows, rows, frame)
            images = [x.reshape(rows, N, 3) for x in (pt.color, pt.emission, pt.albedo)]
            for name, got, want in zip(("color", "emission", "albedo"),
                                       render_tiled(scene, snap, cfg, mesh, N, N, frame=frame),
                                       images):
                assert torch.equal(got, want), name
            _, _, pt_color = render_frame_sharded(scene, snap, shard_state(state, mesh), cfg,
                                                  N, N, mesh, halo=dryrun.CHECK_HALO)
            assert torch.equal(pt_color, images[0])
            assert torch.equal(images[0], whole.pt_color[rank * rows:(rank + 1) * rows])
