"""The SVGF + TAA denoising pipeline (counterpart of tpuray/denoise/svgf.py).

Wires the stages as the reference frame loop does (main.cpp:474-553):
reproject -> spatial variance fallback -> N a-trous iterations with step
1 << i (the output of iteration `history_atrous_tap` is next frame's
illumination history) -> modulate -> TAA.

cfg.pallas_denoise keeps the JAX package's meaning: True routes the moving
camera's reproject + variance through K4 and the a-trous chain through K5
(kernels/reproject.py, kernels/atrous.py; on CPU tensors those wrappers
run their plain versions), False takes the plain PyTorch stages. The
static-camera branch reprojects with the plain static specialisation, as
the JAX package does, and still runs K5.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpuray_torch.denoise.modulate import modulate
from tpuray_torch.denoise.taa import taa
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


def svgf_pipeline(color: Tensor, emission: Tensor, albedo: Tensor,
                  gbuf: GBuffer, state: FrameState, cfg: RenderConfig,
                  static_camera: bool = False) -> SVGFOutput:
    inputs = dict(
        color=color, emission=emission, albedo=albedo, motion=gbuf.velocity,
        normal=gbuf.normal, linear_z=gbuf.linear_z,
        fwidth_normal=gbuf.fwidth_normal, fwidth_z=gbuf.fwidth_z,
        prev_illum=state.illum_hist, prev_variance=state.variance_hist,
        prev_normal=state.prev_normal, prev_linear_z=state.prev_linear_z,
        prev_moments=state.moments, prev_history_len=state.history_len)
    inputs = {k: v.contiguous() for k, v in inputs.items()}
    if static_camera:
        fused = kreproject.reproject_variance_plain(cfg, static_camera=True, **inputs)
    elif cfg.pallas_denoise:
        fused = kreproject.reproject_variance_fused(cfg, **inputs)
    else:
        fused = kreproject.reproject_variance_plain(cfg, **inputs)

    chain = katrous.atrous_chain if cfg.pallas_denoise else katrous.atrous_chain_plain
    (illum, variance), (history_tap, history_tap_var) = chain(
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
