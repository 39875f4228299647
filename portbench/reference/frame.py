"""The reference frame, stage by stage: trace and shade, G-buffer and
progressive accumulation, SVGF (reproject + variance fallback, a-trous
chain, modulate), TAA, and the temporal state a frame hands to the next.

The sequence of tpuray_torch/render/renderer.py:render_frame and
denoise/svgf.py's plain stages on the whole image (the exact history
read, the moving camera). Each stage is a function of its own inputs, so
that a check can run any stage on the program's inputs to that stage.
`store` rounds what each stage hands on (the identity for the reference;
the check's control passes a rounding to a lower precision).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from portbench.reference.camera import pixel_directions
from portbench.reference.config import RenderConfig
from portbench.reference.denoise.atrous import atrous_iteration
from portbench.reference.denoise.modulate import modulate
from portbench.reference.denoise.reproject import reproject
from portbench.reference.denoise.taa import taa
from portbench.reference.denoise.variance import estimate_variance
from portbench.reference.gbuffer import GBuffer, build_gbuffer
from portbench.reference.shade import RefScene, trace_paths

Tensor = torch.Tensor
STATE_FIELDS = ("illum_hist", "variance_hist", "prev_normal", "prev_linear_z", "moments",
                "history_len", "accum_color", "taa_color", "prev_view_proj")


def identity(x: Tensor) -> Tensor:
    return x


def initial_state(height: int, width: int, device) -> dict:
    """The first frame's history: zeros, sky depth, the identity view."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return dict(illum_hist=z(height, width, 3), variance_hist=z(height, width),
                prev_normal=z(height, width, 3),
                prev_linear_z=torch.ones((height, width), dtype=torch.float32, device=device),
                moments=z(height, width, 2), history_len=z(height, width),
                accum_color=z(height, width, 3), taa_color=z(height, width, 3),
                frame_idx=0, prev_view_proj=torch.eye(4, dtype=torch.float32, device=device))


@torch.no_grad()
def trace_stage(scene: RefScene, cam: dict, state: dict, cfg: RenderConfig,
                store: Callable = identity) -> dict:
    """The 1-spp image (accumulated under cfg.accumulate), the first hits'
    emission and albedo, and the G-buffer."""
    h, w = cfg.height, cfg.width
    dev = cam["eye"].device
    yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    xx, yy = xx.reshape(-1), yy.reshape(-1)
    d = pixel_directions(cam, h, w, xx, yy)
    pt = trace_paths(scene, cam["eye"], d, xx, h - 1 - yy, state["frame_idx"], cfg)
    color = pt.color.reshape(h, w, 3)
    if cfg.accumulate:
        t = float(np.float32(1.0) / (np.float32(state["frame_idx"]) + np.float32(1.0)))
        color = state["accum_color"] + (color - state["accum_color"]) * t
    gbuf = build_gbuffer(point=pt.point.reshape(h, w, 3), normal=pt.normal.reshape(h, w, 3),
                         valid=pt.valid.reshape(h, w), view_proj=cam["view_proj"],
                         prev_view_proj=state["prev_view_proj"])
    return dict(pt_color=store(color), emission=store(pt.emission.reshape(h, w, 3)),
                albedo=store(pt.albedo.reshape(h, w, 3)),
                gbuffer=GBuffer(*(store(x) for x in gbuf)))


@torch.no_grad()
def reproject_stage(color, emission, albedo, gbuf: GBuffer, state: dict,
                    cfg: RenderConfig, store: Callable = identity) -> dict:
    """Reprojection with the exact history read, then the spatial variance
    fallback (what K4 fuses)."""
    rep = reproject(color, emission, albedo, gbuf.velocity, gbuf.normal, gbuf.linear_z,
                    gbuf.fwidth_normal, gbuf.fwidth_z, state["illum_hist"],
                    state["variance_hist"], state["prev_normal"], state["prev_linear_z"],
                    state["moments"], state["history_len"], cfg=cfg)
    var = estimate_variance(rep.illum, rep.variance, rep.moments, rep.history_len,
                            gbuf.normal, gbuf.linear_z, gbuf.fwidth_z, cfg)
    return dict(reprojected=store(rep.illum), reprojected_var=store(rep.variance),
                moments=store(rep.moments), history_len=store(rep.history_len),
                variance_illum=store(var.illum), variance_var=store(var.variance))


@torch.no_grad()
def atrous_stage(illum, variance, gbuf: GBuffer, cfg: RenderConfig,
                 store: Callable = identity) -> dict:
    """cfg.num_atrous_iterations iterations at steps 1 << i; the output of
    iteration cfg.history_atrous_tap is the next frame's history."""
    tap, tap_var = illum, variance
    for i in range(cfg.num_atrous_iterations):
        illum, variance = atrous_iteration(illum, variance, gbuf.normal, gbuf.linear_z,
                                           gbuf.fwidth_z, 1 << i, cfg)
        illum, variance = store(illum), store(variance)
        if i == cfg.history_atrous_tap:
            tap, tap_var = illum, variance
    return dict(atrous=illum, atrous_var=variance, history_tap=tap, history_tap_var=tap_var)


@torch.no_grad()
def modulate_stage(atrous, albedo, emission, gbuf: GBuffer, store: Callable = identity):
    return store(modulate(atrous, albedo, emission, gbuf.linear_z))


@torch.no_grad()
def taa_stage(modulated, gbuf: GBuffer, state: dict, store: Callable = identity):
    return store(taa(modulated, state["taa_color"], gbuf.velocity, gbuf.linear_z,
                     state["frame_idx"]))


def advance(state: dict, cam: dict, traced: dict, gbuf: GBuffer, denoised: dict,
            taa_out: Tensor) -> dict:
    """The history the frame hands to the next one."""
    return dict(illum_hist=denoised["history_tap"], variance_hist=denoised["history_tap_var"],
                prev_normal=gbuf.normal, prev_linear_z=gbuf.linear_z,
                moments=denoised["moments"], history_len=denoised["history_len"],
                accum_color=traced["pt_color"], taa_color=taa_out,
                frame_idx=state["frame_idx"] + 1, prev_view_proj=cam["view_proj"])


@torch.no_grad()
def render_frame(scene: RefScene, cam: dict, state: dict, cfg: RenderConfig,
                 store: Callable = identity) -> tuple[dict, dict]:
    """The whole frame from `state` -> (outputs by the program's names,
    the next state)."""
    tr = trace_stage(scene, cam, state, cfg, store)
    g = tr["gbuffer"]
    rv = reproject_stage(tr["pt_color"], tr["emission"], tr["albedo"], g, state, cfg, store)
    at = atrous_stage(rv["variance_illum"], rv["variance_var"], g, cfg, store)
    mod = modulate_stage(at["atrous"], tr["albedo"], tr["emission"], g, store)
    ta = taa_stage(mod, g, state, store)
    out = dict(tr, **rv, **at, modulated=mod, taa=ta, final=ta)
    return out, advance(state, cam, tr, g, dict(rv, **at), ta)
