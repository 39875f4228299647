"""The SVGF + TAA denoising pipeline (counterpart of tpuray/denoise/svgf.py).

Wires the stages as the reference frame loop does (main.cpp:474-553):
reproject -> spatial variance fallback -> N a-trous iterations with step
1 << i (the output of iteration `history_atrous_tap` is next frame's
illumination history) -> modulate -> TAA.

cfg.pallas_denoise keeps the JAX package's meaning: True routes the moving
camera's reproject + variance through K4 and each a-trous iteration
through K5 (kernels/reproject.py, kernels/atrous.py; on CPU tensors those
wrappers run their plain versions), False takes the plain PyTorch stages.
The static-camera branch reprojects with the plain static specialisation
on CPU tensors, as the JAX package does off its own device, and still
runs K5; on the card it runs K4 at zero motion, the specialisation's
meaning (the Renderer and the CLI pick no static branch on the card at
all: render/renderer.py:still_camera).

The moving camera's history read is the config's (denoise/reproject.py:
gather_mode: "auto" and "exact" the exact read, "tiled" the tile-windowed
read, fast_reproject the shifted rescue), in reproject or K4 and, as
tpuray does, in TAA under "tiled" (tpuray/denoise/svgf.py:109-112). One
pipeline serves all three.

svgf_pipeline is also the sharded frame's denoiser (dist/frame.py): its
`rows` say which rows of the image the stages see. The default is the
whole image; a row shard of a frame split across ranks extends each
stage's inputs with its neighbours' rows, passes the stages (plain or
kernel) their global row window and crops the result, so one stage
sequence serves both. K4 fuses reproject and the variance fallback, so on
a shard it reprojects the 3 rows past each edge that the fallback reads
itself, where the plain stages take those rows from the neighbour. Under
the exact read K4 runs on rows extended by rows.halo + 3 (its taps reach
the halo past those rows; ROADMAP.md §3: the two differ only where the
history taps travel farther than the halo); under the tiled read on the
plain stage's rows extended by rows.halo, whose tiles the read takes
(ROADMAP.md §3: those 3 rows can resolve differently in the neighbour's
tiles). A shard reads "tiled" under fast_reproject (reproject.
history_read), in TAA too.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpuray_torch.denoise.atrous import atrous_iteration
from tpuray_torch.denoise.modulate import modulate
from tpuray_torch.denoise.reproject import ReprojectOutput, history_read, reproject
from tpuray_torch.denoise.taa import taa
from tpuray_torch.denoise.variance import estimate_variance
from tpuray_torch.integrator.gbuffer import GBuffer
from tpuray_torch.kernels import atrous as katrous
from tpuray_torch.kernels import reproject as kreproject
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.utils.metrics import span

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
    """The rows the stages run on: this base is the whole image (no
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


def svgf_pipeline(color: Tensor, emission: Tensor, albedo: Tensor, gbuf: GBuffer,
                  state: FrameState, cfg: RenderConfig, static_camera: bool = False,
                  rows: ImageRows = WHOLE_IMAGE) -> SVGFOutput:
    """The pipeline on `rows` of the image: K4 and K5 under
    cfg.pallas_denoise, else the plain stages.

    The frame's inputs and the history are extended once, by the widest
    reach of any stage; each stage then narrows them to its own. The
    stages' outputs are extended again before the next stage reads them:
    K4 reads rows.halo + 3 rows under the exact read (the reprojection and
    the fallback on its output), rows.halo under the tiled read; the plain
    reproject rows.halo and the variance fallback 3; a-trous
    iteration i 2 * 2^i + 1 (its taps and the variance pre-blur), TAA
    rows.halo or at least 2."""
    with span("tpuray.svgf"):
        kernels = cfg.pallas_denoise
        k = rows.halo
        # the tiled read never leaves the plain stage's rows, whose tiles it
        # takes: K4 reads those rows (the fallback's 3 past the shard lie
        # inside the halo)
        tiled = history_read(cfg, rows.window(k)) == "tiled"
        kr = k + 3 if kernels and not tiled else k
        g = max(kr, 2 * (1 << max(cfg.num_atrous_iterations - 1, 0)) + 1)
        ext = rows.extend(g, *(x.contiguous() for x in (
            color, emission, albedo, gbuf.velocity, gbuf.normal, gbuf.linear_z,
            gbuf.fwidth_normal, gbuf.fwidth_z)),
            *(getattr(state, f).contiguous() for f in _HISTORY))
        e_normal, e_z, e_fwz = ext[4], ext[5], ext[7]

        def at(x, kk):
            return rows.narrow(x, g, kk)

        if kernels:
            inputs = dict(zip(kreproject.INPUT_NAMES, (at(x, kr) for x in ext[:-1])))
            if static_camera and not color.is_cuda:
                fused = kreproject.reproject_variance_plain(
                    cfg, static_camera=True, row_window=rows.window(kr), **inputs)
            else:
                if static_camera:  # the card has no static K4: K4 at motion 0
                    inputs["motion"] = torch.zeros_like(inputs["motion"])
                fused = kreproject.reproject_variance_fused(
                    cfg, row_window=rows.window(kr), **inputs)
            fused = type(fused)(*(rows.crop(x, kr) for x in fused))
            rep = ReprojectOutput(illum=fused.rep_illum, variance=fused.rep_variance,
                                  moments=fused.moments, history_len=fused.history_len)
            var_illum, var_variance = fused.var_illum, fused.var_variance
            iteration = katrous.atrous_step
        else:
            rep = reproject(*(at(x, k) for x in ext[:-1]), cfg=cfg,
                            static_camera=static_camera, row_window=rows.window(k))
            rep = type(rep)(*(rows.crop(x, k) for x in rep))
            kv = 3
            var = estimate_variance(
                *rows.extend(kv, rep.illum, rep.variance, rep.moments, rep.history_len),
                at(e_normal, kv), at(e_z, kv), at(e_fwz, kv), cfg,
                row_window=rows.window(kv))
            var_illum = rows.crop(var.illum, kv)
            var_variance = rows.crop(var.variance, kv)
            iteration = atrous_iteration

        illum, variance = history_tap, history_tap_var = var_illum, var_variance
        for i in range(cfg.num_atrous_iterations):
            step = 1 << i
            ka = 2 * step + 1
            il, va = iteration(
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
                                tiled_fetch=tiled, row_window=rows.window(kt)), kt)
        return SVGFOutput(
            reprojected=rep.illum, reprojected_var=rep.variance,
            variance_illum=var_illum, variance_var=var_variance,
            atrous=illum, atrous_var=variance,
            history_tap=history_tap, history_tap_var=history_tap_var,
            modulated=mod, taa=taa_out,
            moments=rep.moments, history_len=rep.history_len)
