"""The port's denoiser stages against tpuray's, on the CPU.

Each test feeds the same numpy inputs (made from a seed) to the JAX stage
and to its tpuray_torch counterpart. Tolerance: rtol 2e-5 / atol 2e-5 (the
JAX package's own tests, tests/test_atrous_pallas.py), history_len exact.
The two sides differ by last-bit rounding only: XLA on the CPU contracts
multiply-adds into FMAs and computes `** 128` with exp/log, where the port
multiplies and adds separately and squares seven times (as its CUDA
kernels do); through the 7 squarings a one-ulp difference in n.n' grows to
~1e-5 relative in the normal weight. No input here puts a back-projected
position or a validity ratio on an exact boundary, so every decision
(floor, tap validity, history length) is the same on both sides.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuray.denoise import atrous as jatrous
from tpuray.denoise import modulate as jmodulate
from tpuray.denoise import reproject as jreproject
from tpuray.denoise import svgf as jsvgf
from tpuray.denoise import taa as jtaa
from tpuray.denoise import variance as jvariance
from tpuray.integrator.gbuffer import GBuffer as JGBuffer
from tpuray.render.frame_state import FrameState as JFrameState
from tpuray.scene.config import RenderConfig as JRenderConfig

from tpuray_torch.denoise import atrous, modulate, reproject, svgf, taa, variance
from tpuray_torch.integrator.gbuffer import GBuffer
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.scene.config import RenderConfig

torch.set_num_threads(2)

H, W = 32, 48
RTOL = ATOL = 2e-5


def _close(got, ref, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=name)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unit(rng, shape):
    n = rng.normal(size=shape + (3,)).astype(np.float32)
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def gbuffer_arrays(rng, h=H, w=W, sky_rows=0):
    """A smooth surface (normals near +z, depth a gentle ramp) with noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    n = np.zeros((h, w, 3), np.float32)
    n[..., 2] = 1.0
    n += 0.1 * _unit(rng, (h, w))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    z = (2.0 + 0.01 * xx + 0.02 * yy
         + 0.003 * rng.random((h, w))).astype(np.float32)
    z[:sky_rows] = 1.0
    n[:sky_rows] = 0.0
    return dict(normal=n, linear_z=z,
                fwidth_normal=rng.uniform(0.01, 0.1, (h, w)).astype(np.float32),
                fwidth_z=rng.uniform(0.005, 0.03, (h, w)).astype(np.float32))


def reproject_arrays(rng, motion, h=H, w=W, sky_rows=0, hist=5.0):
    g = gbuffer_arrays(rng, h, w, sky_rows)
    prev_hist = (np.full((h, w), hist, np.float32) if np.isscalar(hist)
                 else hist.astype(np.float32))
    return dict(
        color=rng.random((h, w, 3)).astype(np.float32),
        emission=(0.1 * rng.random((h, w, 3))).astype(np.float32),
        albedo=rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32),
        motion=motion.astype(np.float32), **g,
        prev_illum=rng.random((h, w, 3)).astype(np.float32),
        prev_variance=rng.random((h, w)).astype(np.float32),
        prev_normal=g["normal"].copy(), prev_linear_z=g["linear_z"].copy(),
        prev_moments=rng.random((h, w, 2)).astype(np.float32),
        prev_history_len=prev_hist)


def _motion(fx, fy, h=H, w=W):
    """Motion in uv units from per-pixel pixel offsets."""
    m = np.zeros((h, w, 2), np.float32)
    m[..., 0] = np.broadcast_to(fx, (h, w)) / w
    m[..., 1] = np.broadcast_to(fy, (h, w)) / h
    return m


def _case(name, rng):
    yy, xx = np.mgrid[0:H, 0:W]
    quirks = False
    if name == "smooth":
        a = reproject_arrays(rng, _motion(2.25, 1.5))
    elif name == "rescue_block":
        # the bilinear taps fail on depth inside the block; the rescue's
        # 3x3 ring reaches valid texels at its edges
        a = reproject_arrays(rng, _motion(0.3, -0.4))
        a["prev_linear_z"][8:16, 10:20] += 5.0
    elif name == "sky_band":
        a = reproject_arrays(rng, _motion(-1.75, 0.5), sky_rows=6)
        a["prev_linear_z"] = a["linear_z"].copy()
    elif name == "low_history":
        a = reproject_arrays(rng, _motion(1.2, 0.7),
                             hist=np.floor(rng.random((H, W)) * 6))
    elif name == "border":
        # x0 = -1 in the left column and x0 = W-1 in the right one (y alike),
        # where the clamped quad reads texels 0,1 / W-1,W-1
        a = reproject_arrays(rng, _motion(np.where(xx < W // 2, 0.25, -0.25),
                                          np.where(yy < H // 2, 0.3, -0.3)))
    elif name == "quirks_negative_uv":
        a = reproject_arrays(rng, _motion(3.3, 2.6))
        quirks = True
    else:
        raise ValueError(name)
    return a, quirks


REPROJECT_CASES = ["smooth", "rescue_block", "sky_band", "low_history",
                   "border", "quirks_negative_uv", "static"]


@pytest.mark.parametrize("name", REPROJECT_CASES)
def test_reproject_matches(name):
    rng = np.random.default_rng(100 + REPROJECT_CASES.index(name))
    static = name == "static"
    if static:
        a = reproject_arrays(rng, np.zeros((H, W, 2)),
                             hist=np.floor(rng.random((H, W)) * 6))
        a["prev_linear_z"][4:9, 4:30] += 5.0  # rescued from static shifts
        quirks = False
    else:
        a, quirks = _case(name, rng)
    jcfg = JRenderConfig(width=W, height=H, reproject_gather="exact",
                         reference_quirks=quirks)
    cfg = RenderConfig(width=W, height=H, reproject_gather="exact",
                       reference_quirks=quirks)
    ref = jreproject.reproject(**{k: jnp.asarray(v) for k, v in a.items()},
                               cfg=jcfg, static_camera=static)
    got = reproject.reproject(**{k: _t(v) for k, v in a.items()}, cfg=cfg,
                              static_camera=static)
    for f in ("illum", "variance", "moments"):
        _close(getattr(got, f), getattr(ref, f), f"{name}: {f}")
    np.testing.assert_array_equal(got.history_len.numpy(),
                                  np.asarray(ref.history_len), err_msg=name)
    # each case exercises what it names: a successful reprojection extends
    # the history by one frame, a failed one restarts it at 1
    extended = got.history_len.numpy() == np.minimum(
        a["prev_history_len"] + 1.0, cfg.history_cap)
    if name in ("smooth", "border", "quirks_negative_uv", "static"):
        assert extended.mean() > 0.5
    if name == "rescue_block":
        assert extended[8:16, 10:20].any()
    if name == "static":
        assert extended[4:9, 4:30].any()
    if name == "sky_band":
        np.testing.assert_array_equal(got.illum[:6].numpy(), a["color"][:6])


@pytest.mark.parametrize("read", ["tiled", "fast"])
@pytest.mark.parametrize("name", REPROJECT_CASES[:-1] + ["torn"])
def test_reproject_reads_match(read, name):
    """reproject under reproject_gather="tiled" (the tile-windowed read) and
    under fast_reproject=True (the shifted rescue) against tpuray's under
    the same config; "torn": a motion field with a jump of 7 and 5 pixels
    down the middle and a block of per-pixel random motion."""
    rng = np.random.default_rng(200 + REPROJECT_CASES.index(name)
                                if name in REPROJECT_CASES else 299)
    if name == "torn":
        yy, xx = np.mgrid[0:H, 0:W]
        m = _motion(np.where(xx < W // 2, 0.6, -6.6), np.where(xx < W // 2, -0.3, 4.7))
        m[20:28, 4:16] = (rng.random((8, 12, 2)) - 0.5) * 0.2
        a, quirks = reproject_arrays(rng, m), False
    else:
        a, quirks = _case(name, rng)
    kw = dict(reproject_gather="tiled") if read == "tiled" else dict(fast_reproject=True)
    ref = jreproject.reproject(**{k: jnp.asarray(v) for k, v in a.items()},
                               cfg=JRenderConfig(width=W, height=H, reference_quirks=quirks, **kw))
    got = reproject.reproject(**{k: _t(v) for k, v in a.items()},
                              cfg=RenderConfig(width=W, height=H, reference_quirks=quirks, **kw))
    for f in ("illum", "variance", "moments"):
        _close(getattr(got, f), getattr(ref, f), f"{read} {name}: {f}")
    np.testing.assert_array_equal(got.history_len.numpy(), np.asarray(ref.history_len))
    extended = (got.history_len.numpy() > 1.0).mean()
    if name == "torn" and read == "tiled":
        # the image is one 40 x 160 tile, whose residuals span more than the
        # window: the tiled read resolves almost nothing
        assert extended < 0.05
    else:
        assert extended > 0.3


def test_gather_mode_raises_for_tpu_only_reads():
    """Every read of tpuray's RenderConfig resolves; "auto" is the exact read
    on every device; an unknown read raises. With a row window the shifted
    rescue reads tile-windowed, as tpuray's sharded stage does."""
    assert reproject.gather_mode(RenderConfig()) == "exact"
    assert reproject.gather_mode(RenderConfig(reproject_gather="exact")) == "exact"
    assert reproject.gather_mode(RenderConfig(reproject_gather="tiled")) == "tiled"
    assert reproject.gather_mode(RenderConfig(fast_reproject=True)) == "fast"
    assert reproject.history_read(RenderConfig(fast_reproject=True), (8, 64)) == "tiled"
    assert reproject.history_read(RenderConfig(), (8, 64)) == "exact"
    with pytest.raises(ValueError, match="unknown reproject_gather"):
        reproject.gather_mode(RenderConfig(reproject_gather="quad"))


def test_estimate_variance_matches():
    rng = np.random.default_rng(3)
    g = gbuffer_arrays(rng, sky_rows=3)
    a = dict(illum=rng.random((H, W, 3)).astype(np.float32) * 2.0,
             variance=rng.random((H, W)).astype(np.float32),
             moments=rng.random((H, W, 2)).astype(np.float32),
             history_len=np.floor(rng.random((H, W)) * 7).astype(np.float32),
             normal=g["normal"], linear_z=g["linear_z"], fwidth_z=g["fwidth_z"])
    ref = jvariance.estimate_variance(**{k: jnp.asarray(v) for k, v in a.items()},
                                      cfg=JRenderConfig())
    got = variance.estimate_variance(**{k: _t(v) for k, v in a.items()},
                                     cfg=RenderConfig())
    _close(got.illum, ref.illum, "illum")
    _close(got.variance, ref.variance, "variance")
    assert ((a["history_len"] < 4) & (a["linear_z"] != 1.0)).any()


def atrous_arrays(rng, h=H, w=W):
    g = gbuffer_arrays(rng, h, w, sky_rows=4)
    return (rng.uniform(0.0, 4.0, (h, w, 3)).astype(np.float32),
            rng.uniform(0.0, 1.0, (h, w)).astype(np.float32),
            g["normal"], g["linear_z"], g["fwidth_z"])


@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("step", [1, 2, 4])
def test_atrous_iteration_matches(step, quirks):
    args = atrous_arrays(np.random.default_rng(10 + step))
    ri, rv = jatrous.atrous_iteration(*map(jnp.asarray, args), step=step,
                                      cfg=JRenderConfig(reference_quirks=quirks))
    gi, gv = atrous.atrous_iteration(*map(_t, args), step=step,
                                     cfg=RenderConfig(reference_quirks=quirks))
    _close(gi, ri, "illum")
    _close(gv, rv, "variance")


def test_modulate_matches():
    rng = np.random.default_rng(4)
    g = gbuffer_arrays(rng, sky_rows=5)
    a = [rng.random((H, W, 3)).astype(np.float32) for _ in range(3)]
    ref = jmodulate.modulate(*map(jnp.asarray, a), jnp.asarray(g["linear_z"]))
    got = modulate.modulate(*map(_t, a), _t(g["linear_z"]))
    _close(got, ref, "modulate")


@pytest.mark.parametrize("mode", ["frame0", "moving", "static"])
def test_taa_matches(mode):
    rng = np.random.default_rng(5)
    g = gbuffer_arrays(rng, sky_rows=3)
    yy, xx = np.mgrid[0:H, 0:W]
    # sub-pixel motion with a discontinuity, so the closest-depth dilation
    # and the clamped bilinear fetch at the border both matter, slow enough
    # (|vel| < 0.0095) that the history keeps a share of the blend
    vel = _motion(np.where(xx < W // 3, -0.25, 0.2), np.where(yy < H // 2, 0.2, -0.15))
    cur = rng.random((H, W, 3)).astype(np.float32) * 2.0
    prev = rng.random((H, W, 3)).astype(np.float32) * 2.0
    frame = 0 if mode == "frame0" else 3
    static = mode == "static"
    ref = jtaa.taa(jnp.asarray(cur), jnp.asarray(prev), jnp.asarray(vel),
                   jnp.asarray(g["linear_z"]), frame, static_camera=static)
    got = taa.taa(_t(cur), _t(prev), _t(vel), _t(g["linear_z"]), frame,
                  static_camera=static)
    _close(got, ref, mode)
    if mode != "frame0":
        assert np.abs(np.asarray(ref) - cur).max() > 1e-3


def test_svgf_pipeline_matches():
    rng = np.random.default_rng(6)
    a = reproject_arrays(rng, _motion(0.8, -1.3), sky_rows=4,
                         hist=np.floor(rng.random((H, W)) * 6))
    vel = a["motion"]
    gb = dict(normal=a["normal"], linear_z=a["linear_z"], velocity=vel,
              fwidth_normal=a["fwidth_normal"], fwidth_z=a["fwidth_z"],
              world_pos=np.zeros((H, W, 3), np.float32))
    st = dict(illum_hist=a["prev_illum"], variance_hist=a["prev_variance"],
              prev_normal=a["prev_normal"], prev_linear_z=a["prev_linear_z"],
              moments=a["prev_moments"], history_len=a["prev_history_len"],
              accum_color=a["color"], taa_color=rng.random((H, W, 3)).astype(np.float32))
    col = [a["color"], a["emission"], a["albedo"]]
    jst = JFrameState(**{k: jnp.asarray(v) for k, v in st.items()},
                      frame_idx=jnp.asarray(2, jnp.int32),
                      prev_view_proj=jnp.eye(4, dtype=jnp.float32))
    tst = FrameState(**{k: _t(v) for k, v in st.items()}, frame_idx=2,
                     prev_view_proj=torch.eye(4))
    ref = jsvgf.svgf_pipeline(*map(jnp.asarray, col),
                              JGBuffer(**{k: jnp.asarray(v) for k, v in gb.items()}),
                              jst, JRenderConfig(width=W, height=H))
    got = svgf.svgf_pipeline(*map(_t, col),
                             GBuffer(**{k: _t(v) for k, v in gb.items()}),
                             tst, RenderConfig(width=W, height=H))
    assert got._fields == ref._fields
    for f in got._fields:
        if f == "history_len":
            np.testing.assert_array_equal(got.history_len.numpy(),
                                          np.asarray(ref.history_len))
        else:
            _close(getattr(got, f), getattr(ref, f), f)
