"""Frame orchestration (counterpart of tpuray/render/renderer.py).

One frame: camera rays in 32x32 tile order, the path tracer (on a single
tree K1 for the primaries and K2 per bounce, or K3 for separate walks and
the MIS integrator; on a chunked forest K6 for every walk), progressive
accumulation, the G-buffer, the SVGF + TAA denoiser (K4 for reproject +
variance, K5 for the a-trous chain; denoise/svgf.py), and the FrameState
update.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpuray_torch.denoise.reproject import gather_mode
from tpuray_torch.denoise.svgf import SVGFOutput, svgf_pipeline
from tpuray_torch.integrator.gather_tables import PackedScene, pack_scene_tables
from tpuray_torch.integrator.gbuffer import GBuffer, build_gbuffer
from tpuray_torch.integrator.intersect import norm
from tpuray_torch.integrator.path_tracer import (
    KERNELS, Tracer, check_config, pack_traversal, resolve_aniso, trace_paths)
from tpuray_torch.kernels.trace import TraceTables
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.render.tiling import tile_pixel_coords, untile
from tpuray_torch.scene.config import DebugView, RenderConfig
from tpuray_torch.scene.types import Camera

Tensor = torch.Tensor


class FrameOutputs(NamedTuple):
    pt_color: Tensor     # (H, W, 3) 1spp (or accumulated) color
    accum_color: Tensor  # (H, W, 3)
    svgf: SVGFOutput
    gbuffer: GBuffer
    final: Tensor        # (H, W, 3)
    coverage: Tensor     # () fraction of primary rays that hit geometry


def tonemap(c: Tensor, limit: float = 1.5, gamma: float = 2.2) -> Tensor:
    """Reinhard-style luminance compression, then gamma."""
    lum = 0.3 * c[..., 0] + 0.6 * c[..., 1] + 0.1 * c[..., 2]
    c = c / (1.0 + lum / limit)[..., None]
    return torch.pow(torch.clamp_min(c, 0.0), 1.0 / gamma)


def camera_rays(camera: Camera, height: int, width: int
                ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Primary rays in 32x32-tile order -> (orig (N, 3) view, d (N, 3),
    px, py). px/py are GL frag coords (bottom-up), padding rows included."""
    dev = camera.eye.device
    xx, yy = tile_pixel_coords(height, width, dev)
    n = xx.shape[0]
    th = camera.tan_half_fov
    xs = (2.0 * (xx.to(torch.float32) + 0.5) / width - 1.0) * th
    ys = -((2.0 * (yy.to(torch.float32) + 0.5) / height - 1.0) * th)
    c = camera.cam_to_world
    # d = cam_to_world @ (xs, ys, -1), written out elementwise
    d = torch.stack([c[i, 0] * xs + c[i, 1] * ys + c[i, 2] * -1.0
                     for i in range(3)], dim=-1)
    d = d / norm(d)
    orig = camera.eye.expand(n, 3)
    return orig, d, xx, height - 1 - yy


def render_frame(scene, camera: Camera, state: FrameState, cfg: RenderConfig,
                 height: int, width: int,
                 tracer: Tracer = KERNELS,
                 tables: TraceTables | None = None,
                 pk: PackedScene | None = None,
                 static_camera: bool = False
                 ) -> tuple[FrameState, FrameOutputs]:
    """Render one frame and advance the temporal state.

    static_camera=True takes the denoiser's static-camera specialisation
    (motion == 0); the Renderer selects it when the view is unchanged.
    Differentiable with enable_svgf=False, or with pallas_denoise=False
    (K4 and K5 are forward-only and raise under grad)."""
    frame = state.frame_idx
    orig, d, px, py = camera_rays(camera, height, width)
    pt = trace_paths(scene, orig, d, px, py, frame, cfg, common_origin=True,
                     tracer=tracer, tables=tables, pk=pk)

    color = untile(pt.color, height, width)
    emission = untile(pt.emission, height, width)
    albedo = untile(pt.albedo, height, width)
    if cfg.accumulate:
        t = float(np.float32(1.0) / (np.float32(frame) + np.float32(1.0)))
        accum = state.accum_color + (color - state.accum_color) * t
    else:
        accum = color
    pt_color = accum

    gbuf = build_gbuffer(
        point=untile(pt.first_hit_point, height, width),
        normal=untile(pt.first_hit_normal, height, width),
        valid=untile(pt.first_hit_valid, height, width),
        view_proj=camera.view_proj, prev_view_proj=state.prev_view_proj)

    if cfg.enable_svgf:
        svgf = svgf_pipeline(pt_color, emission, albedo, gbuf, state, cfg,
                             static_camera=static_camera)
        final = svgf.taa if cfg.enable_taa else svgf.modulated
        new_state = state.replace(
            illum_hist=svgf.history_tap, variance_hist=svgf.history_tap_var,
            prev_normal=gbuf.normal, prev_linear_z=gbuf.linear_z,
            moments=svgf.moments, history_len=svgf.history_len,
            accum_color=accum, taa_color=svgf.taa, frame_idx=frame + 1,
            prev_view_proj=camera.view_proj)
    else:
        z1 = torch.zeros((height, width), dtype=torch.float32,
                         device=color.device)
        svgf = SVGFOutput(
            reprojected=pt_color, reprojected_var=z1, variance_illum=pt_color,
            variance_var=z1, atrous=pt_color, atrous_var=z1,
            history_tap=pt_color, history_tap_var=z1, modulated=pt_color,
            taa=pt_color,
            moments=torch.zeros((height, width, 2), dtype=torch.float32,
                                device=color.device),
            history_len=z1)
        final = pt_color
        new_state = state.replace(
            prev_normal=gbuf.normal, prev_linear_z=gbuf.linear_z,
            accum_color=accum, taa_color=final, frame_idx=frame + 1,
            prev_view_proj=camera.view_proj)
    outputs = FrameOutputs(
        pt_color=pt_color, accum_color=accum, svgf=svgf, gbuffer=gbuf,
        final=final,
        coverage=torch.mean(pt.first_hit_valid.to(torch.float32)))
    return new_state, outputs


def select_debug_view(outputs: FrameOutputs, view: DebugView) -> Tensor:
    table = {
        DebugView.PATH_TRACING_1SPP: outputs.pt_color,
        DebugView.SVGF_REPROJECTED: outputs.svgf.reprojected,
        DebugView.SVGF_VARIANCE: outputs.svgf.variance_illum,
        DebugView.SVGF_ATROUS: outputs.svgf.atrous,
        DebugView.SVGF_MODULATE: outputs.svgf.modulated,
        DebugView.TAA: outputs.svgf.taa,
        DebugView.FINAL: outputs.final,
        DebugView.ACCUMULATE_COLOR: outputs.accum_color,
    }
    return table[view]


class Renderer:
    """Owns the scene (on `device`), its packed tables (a forest's for K6 or
    a single tree's), the config and the temporal state, and drives frames.

    device defaults to "cuda"; without a CUDA device the Renderer raises
    unless it is given device="cpu". Cameras may be built anywhere: step()
    moves them to the Renderer's device, and chooses the static-camera
    branch from a host copy of the view matrix (a camera built on the host,
    as OrbitCamera.snapshot() does by default, costs no device read)."""

    def __init__(self, scene, cfg: RenderConfig, device="cuda",
                 tracer: Tracer = KERNELS):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Renderer: no CUDA device is available; pass device='cpu' "
                "to render on the CPU")
        check_config(cfg)
        if cfg.enable_svgf:
            gather_mode(cfg)
        scene = scene.to(device)
        if cfg.enable_aniso == "auto":
            cfg = dataclasses.replace(cfg, enable_aniso=resolve_aniso(scene, cfg))
        self.scene = scene
        self.cfg = cfg
        self.device = scene.triangles.p0.device
        self.tracer = tracer
        with torch.no_grad():  # serving keeps no graph, even of trainable tables
            self.tables = pack_traversal(scene)
            self.pk = pack_scene_tables(scene)
        self.state = FrameState.initial(cfg.height, cfg.width, self.device)
        self._prev_view_proj = np.eye(4, dtype=np.float32)  # host copy
        self.last_outputs: FrameOutputs | None = None

    def reset(self) -> None:
        self.state = self.state.reset_accumulation()

    @torch.no_grad()
    def step(self, camera: Camera) -> FrameOutputs:
        """Render the next frame. Serving builds no autograd graph, whatever
        the scene's tensors require (render_frame differentiates)."""
        view_proj = camera.view_proj.detach().cpu().numpy()
        static = bool(self.state.frame_idx > 0
                      and np.allclose(view_proj, self._prev_view_proj))
        self.state, out = render_frame(
            self.scene, camera.to(self.device), self.state, self.cfg,
            self.cfg.height, self.cfg.width, tracer=self.tracer,
            tables=self.tables, pk=self.pk, static_camera=static)
        self._prev_view_proj = view_proj
        self.last_outputs = out
        return out

    def render(self, camera: Camera, n_frames: int = 1) -> FrameOutputs:
        out = None
        for _ in range(n_frames):
            out = self.step(camera)
        return out

    def display_image(self, view: DebugView = DebugView.FINAL) -> np.ndarray:
        img = select_debug_view(self.last_outputs, view)
        return tonemap(img, self.cfg.tonemap_limit, self.cfg.gamma).cpu().numpy()
