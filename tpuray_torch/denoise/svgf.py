"""The SVGF + TAA denoising pipeline (counterpart of tpuray/denoise/svgf.py).

Wires the stages as the reference frame loop does (main.cpp:474-553):
reproject -> spatial variance fallback -> N a-trous iterations with step
1 << i (the output of iteration `history_atrous_tap` is next frame's
illumination history) -> modulate -> TAA.

cfg.pallas_denoise keeps the JAX package's meaning: True routes the moving
camera's reproject + variance through K4 and the a-trous chain through K5
(kernels/reproject.py, kernels/atrous.py; on CPU tensors those wrappers
run their plain versions), False takes the plain PyTorch stages
(plain_svgf). The static-camera branch reprojects with the plain static
specialisation, as the JAX package does off its own device, and still
runs K5; on the card a still camera is a moving one with zero motion
(render/renderer.py:still_camera), so the branch takes CPU tensors only.

plain_svgf is also the sharded frame's denoiser (dist/frame.py): its
`rows` say which rows of the image the stages see. The default is the
whole image; a row shard of a frame split across ranks extends each
stage's inputs with its neighbours' rows, passes the stages their global
row window and crops the result, so one stage sequence serves both.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpuray_torch.denoise.atrous import atrous_iteration
from tpuray_torch.denoise.modulate import modulate
from tpuray_torch.denoise.reproject import reproject
from tpuray_torch.denoise.taa import taa
from tpuray_torch.denoise.variance import estimate_variance
from tpuray_torch.integrator.gbuffer import GBuffer
from tpuray_torch.kernels import atrous as katrous
from tpuray_torch.kernels import reproject as kreproject
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.scene.config import RenderConfig

Tensor = torch.Tensor


class SVGFOutput(NamedTuple):
    reprojected: Tensor      # (H, W, 3) post-temporal-accumulation illumination
    reprojected_var: Tensor  # (H, W)
    variance_illum: Tensor   # (H, W, 3) after the spatial fallback
    variance_var: Tensor     # (H, W)
    atrous: Tensor           # (H, W, 3) final a-trous output
    atrous_var: Tensor       # (H, W)
    history_tap: Tensor      # (H, W, 3) the feedback tap for next frame
    history_tap_var: Tensor  # (H, W)
    modulated: Tensor        # (H, W, 3)
    taa: Tensor              # (H, W, 3)
    moments: Tensor          # (H, W, 2)
    history_len: Tensor      # (H, W)


class ImageRows:
    """The rows the plain stages run on: this base is the whole image (no
    halo, no row window). A subclass for a row shard (dist/frame.py:
    ShardRows) extends a stage's inputs by k rows a side from the
    neighbouring shards, gives the stages the global row window of the
    extended shard, and crops the k rows again."""

    halo = 0  # how far the history reprojection may read past the rows

    def extend(self, k: int, *xs: Tensor) -> tuple[Tensor, ...]:
        return xs

    def narrow(self, x: Tensor, have: int, k: int) -> Tensor:
        """x, extended by `have` rows a side, cut to k rows a side."""
        return x

    def window(self, k: int) -> tuple[int, int] | None:
        """The stages' row_window of the rows extended by k a side."""
        return None

    def crop(self, x: Tensor, k: int) -> Tensor:
        return x


WHOLE_IMAGE = ImageRows()

# the history images the stages read, in reproject's order, then TAA's
_HISTORY = ("illum_hist", "variance_hist", "prev_normal", "prev_linear_z",
            "moments", "history_len", "taa_color")


def plain_svgf(color: Tensor, emission: Tensor, albedo: Tensor, gbuf: GBuffer,
               state: FrameState, cfg: RenderConfig, static_camera: bool = False,
               rows: ImageRows = WHOLE_IMAGE) -> SVGFOutput:
    """The pipeline in the plain PyTorch stages on `rows` of the image.

    The frame's inputs and the history are extended once, by the widest
    reach of any stage; each stage then narrows them to its own. The
    stages' outputs are extended again before the next stage reads them:
    reproject reads rows.halo rows, the variance fallback 3, a-trous
    iteration i 2 * 2^i + 1 (its taps and the variance pre-blur), TAA
    rows.halo or at least 2."""
    k = rows.halo
    g = max(k, 2 * (1 << max(cfg.num_atrous_iterations - 1, 0)) + 1)
    ext = rows.extend(g, *(x.contiguous() for x in (
        color, emission, albedo, gbuf.velocity, gbuf.normal, gbuf.linear_z,
        gbuf.fwidth_normal, gbuf.fwidth_z)),
        *(getattr(state, f).contiguous() for f in _HISTORY))
    e_normal, e_z, e_fwz = ext[4], ext[5], ext[7]

    def at(x, kk):
        return rows.narrow(x, g, kk)

    rep = reproject(*(at(x, k) for x in ext[:-1]), cfg=cfg,
                    static_camera=static_camera, row_window=rows.window(k))
    rep = type(rep)(*(rows.crop(x, k) for x in rep))

    kv = 3
    var = estimate_variance(
        *rows.extend(kv, rep.illum, rep.variance, rep.moments, rep.history_len),
        at(e_normal, kv), at(e_z, kv), at(e_fwz, kv), cfg, row_window=rows.window(kv))
    var_illum, var_variance = rows.crop(var.illum, kv), rows.crop(var.variance, kv)

    illum, variance = history_tap, history_tap_var = var_illum, var_variance
    for i in range(cfg.num_atrous_iterations):
        step = 1 << i
        ka = 2 * step + 1
        il, va = atrous_iteration(
            *rows.extend(ka, illum, variance), at(e_normal, ka), at(e_z, ka),
            at(e_fwz, ka), step, cfg, row_window=rows.window(ka))
        illum, variance = rows.crop(il, ka), rows.crop(va, ka)
        if i == cfg.history_atrous_tap:
            history_tap, history_tap_var = illum, variance

    mod = modulate(illum, albedo, emission, gbuf.linear_z)
    kt = max(k, 2)
    (mod_e,) = rows.extend(kt, mod)
    taa_out = rows.crop(taa(mod_e, at(ext[-1], kt), at(ext[3], kt), at(e_z, kt),
                            state.frame_idx, static_camera=static_camera,
                            row_window=rows.window(kt)), kt)
    return SVGFOutput(
        reprojected=rep.illum, reprojected_var=rep.variance,
        variance_illum=var_illum, variance_var=var_variance,
        atrous=illum, atrous_var=variance,
        history_tap=history_tap, history_tap_var=history_tap_var,
        modulated=mod, taa=taa_out,
        moments=rep.moments, history_len=rep.history_len)


def reproject_inputs(color: Tensor, emission: Tensor, albedo: Tensor,
                     gbuf: GBuffer, state: FrameState) -> dict:
    """K4's keyword inputs (kernels/reproject.py) from a frame's buffers and
    its history, each contiguous."""
    inputs = dict(
        color=color, emission=emission, albedo=albedo, motion=gbuf.velocity,
        normal=gbuf.normal, linear_z=gbuf.linear_z,
        fwidth_normal=gbuf.fwidth_normal, fwidth_z=gbuf.fwidth_z,
        prev_illum=state.illum_hist, prev_variance=state.variance_hist,
        prev_normal=state.prev_normal, prev_linear_z=state.prev_linear_z,
        prev_moments=state.moments, prev_history_len=state.history_len)
    return {k: v.contiguous() for k, v in inputs.items()}


def svgf_pipeline(color: Tensor, emission: Tensor, albedo: Tensor,
                  gbuf: GBuffer, state: FrameState, cfg: RenderConfig,
                  static_camera: bool = False) -> SVGFOutput:
    if not cfg.pallas_denoise:
        return plain_svgf(color, emission, albedo, gbuf, state, cfg, static_camera)
    inputs = reproject_inputs(color, emission, albedo, gbuf, state)
    if static_camera:
        if color.is_cuda:
            raise ValueError("svgf_pipeline: the static-camera branch is plain; on the "
                             "card a still camera takes K4 with zero motion")
        fused = kreproject.reproject_variance_plain(cfg, static_camera=True, **inputs)
    else:
        fused = kreproject.reproject_variance_fused(cfg, **inputs)

    (illum, variance), (history_tap, history_tap_var) = katrous.atrous_chain(
        fused.var_illum.contiguous(), fused.var_variance.contiguous(),
        inputs["normal"], inputs["linear_z"], inputs["fwidth_z"], cfg)

    mod = modulate(illum, albedo, emission, gbuf.linear_z)
    taa_out = taa(mod, state.taa_color, gbuf.velocity, gbuf.linear_z,
                  state.frame_idx, static_camera=static_camera)
    return SVGFOutput(
        reprojected=fused.rep_illum, reprojected_var=fused.rep_variance,
        variance_illum=fused.var_illum, variance_var=fused.var_variance,
        atrous=illum, atrous_var=variance,
        history_tap=history_tap, history_tap_var=history_tap_var,
        modulated=mod, taa=taa_out,
        moments=fused.moments, history_len=fused.history_len)
