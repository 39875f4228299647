"""TAA's kernel wrapper (kernels/taa.py) on the CPU, and its route through
denoise/svgf.py:svgf_pipeline.

The kernel itself runs only on the card (tests/test_torch_gpu.py -k taa
holds it against the plain taa bit for bit). Here:
- on CPU tensors the wrapper runs the plain taa (denoise/taa.py) and counts
  no launch: whole image, row window and static camera, at frame 0 too;
- it refuses an input that requires grad, naming pallas_denoise=False;
- svgf_pipeline takes the wrapper under pallas_denoise and the exact read,
  and the plain taa under the tile-windowed read and under
  pallas_denoise=False.

This file imports no jax: the card's tests import taa_inputs from it.
"""
import numpy as np
import pytest
import torch

from tpuray_torch.denoise import svgf
from tpuray_torch.denoise import taa as plain
from tpuray_torch.integrator.gbuffer import GBuffer
from tpuray_torch.kernels import taa as ktaa
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.scene.config import RenderConfig

torch.set_num_threads(2)


def taa_inputs(seed, h, w, sky="band", fast_rows=None, device="cpu"):
    """TAA's inputs (cur_color, prev_color, velocity, linear_z): a depth
    ramp with noise and a nearer block (the closest-depth dilation picks
    across its edge), sub-pixel motion with a discontinuity, colours in
    [0, 2). sky: "band" (the top eighth and scattered pixels at
    linear_z 1), "all" or "none". fast_rows=(r0, r1, rows): the pixels of
    rows r0..r1 - 1 in the middle third of the columns move `rows` rows a
    frame (their history lies that far above)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    z = 2.0 + 0.01 * xx + 0.02 * yy + 0.5 * rng.random((h, w))
    z[h // 3: h // 2, w // 4: w // 2] -= 1.5
    if sky == "band":
        z[: h // 8] = 1.0
        z[rng.random((h, w)) < 0.02] = 1.0
    elif sky == "all":
        z[:] = 1.0
    vx = np.where(xx < w // 3, -0.25, 0.2) + 0.1 * rng.standard_normal((h, w))
    vy = np.where(yy < h // 2, 0.2, -0.15) + 0.1 * rng.standard_normal((h, w))
    if fast_rows is not None:
        r0, r1, rows = fast_rows
        vy[r0:r1, w // 3: 2 * w // 3] = rows
    vel = np.stack([vx / w, vy / h], -1)
    arrays = (2.0 * rng.random((h, w, 3)), 2.0 * rng.random((h, w, 3)), vel, z)
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device) for a in arrays]


@pytest.mark.parametrize("case", ["whole", "frame0", "row_window", "static",
                                  "static_row_window"])
def test_wrapper_on_cpu_is_the_plain_taa(case):
    a = taa_inputs(3, 40, 56, fast_rows=(20, 30, 9.0))
    kw = {}
    if "row_window" in case:
        a = [x[8:32] for x in a]  # rows 8..31 of 40, extended rows of a shard
        kw["row_window"] = (8, 40)
    kw["static_camera"] = case.startswith("static")
    frame = 0 if case == "frame0" else 3
    ktaa.reset_launches()
    got = ktaa.taa(*a, frame, **kw)
    assert ktaa.LAUNCHES["taa"] == 0
    ref = plain.taa(*a, frame, **kw)
    assert torch.equal(got, ref)
    moved = not torch.equal(got, a[0])
    assert moved == (case != "frame0")


def test_wrapper_refuses_grad():
    a = taa_inputs(4, 8, 8)
    a[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="TAA kernel.*pallas_denoise=False"):
        ktaa.taa(*a, 3)
    with torch.no_grad():  # nothing to lose: the wrapper runs
        ktaa.taa(*a, 3)


def _frame(seed, h, w):
    rng = np.random.default_rng(seed)
    cur, prev, vel, z = taa_inputs(seed, h, w)

    def f(*s):
        return torch.from_numpy(rng.random(s).astype(np.float32))

    n = torch.zeros((h, w, 3))
    n[..., 2] = 1.0
    gbuf = GBuffer(normal=n, linear_z=z, velocity=vel, fwidth_normal=0.01 + 0.1 * f(h, w),
                   fwidth_z=0.005 + 0.03 * f(h, w), world_pos=torch.zeros((h, w, 3)))
    state = FrameState(illum_hist=f(h, w, 3), variance_hist=f(h, w), prev_normal=n.clone(),
                       prev_linear_z=z.clone(), moments=f(h, w, 2),
                       history_len=torch.floor(6 * f(h, w)), accum_color=cur,
                       taa_color=prev, frame_idx=2, prev_view_proj=torch.eye(4))
    return cur, 0.1 * f(h, w, 3), f(h, w, 3), gbuf, state


@pytest.mark.parametrize("route,cfg_kw", [
    ("kernel", {}),
    ("plain", {"reproject_gather": "tiled"}),
    ("plain", {"pallas_denoise": False}),
])
def test_svgf_pipeline_routes_taa(monkeypatch, route, cfg_kw):
    """Which TAA svgf_pipeline calls, and with what: the wrapper takes no
    tiled_fetch, the plain taa under "tiled" takes tiled_fetch=True."""
    calls = []

    def spy(name, fn):
        def call(*args, **kw):
            calls.append((name, kw))
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(svgf.ktaa, "taa", spy("kernel", ktaa.taa))
    monkeypatch.setattr(svgf, "taa", spy("plain", plain.taa))
    h, w = 24, 40
    cfg = RenderConfig(width=w, height=h, **cfg_kw)
    color, emission, albedo, gbuf, state = _frame(7, h, w)
    out = svgf.svgf_pipeline(color, emission, albedo, gbuf, state, cfg)
    assert [name for name, _ in calls] == [route]
    kw = calls[0][1]
    tiled = "reproject_gather" in cfg_kw
    assert kw.get("tiled_fetch", False) == tiled
    assert kw["row_window"] is None and not kw["static_camera"]
    ref = plain.taa(out.modulated, state.taa_color, gbuf.velocity, gbuf.linear_z,
                    state.frame_idx, tiled_fetch=tiled)
    assert torch.equal(out.taa, ref)
