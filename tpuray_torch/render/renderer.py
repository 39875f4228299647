"""Frame orchestration (counterpart of tpuray/render/renderer.py).

One frame: camera rays in 32x32 tile order, the path tracer (on a single
tree K1 for the primaries and K2 per bounce, or K3 for separate walks and
the MIS integrator; on a chunked forest K6 for every walk; with compaction
the bounces shade only the lanes that hit), progressive accumulation, the
G-buffer, the SVGF + TAA denoiser (K4 for reproject + variance, K5 for the
a-trous chain; denoise/svgf.py), and the FrameState update.

The Renderer picks the compaction budget of the next frames from the hit
coverage of an earlier frame (cfg.compact_auto), read a period late so
that the read never waits for the device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpuray_torch.denoise.reproject import gather_mode
from tpuray_torch.denoise.svgf import WHOLE_IMAGE, ImageRows, SVGFOutput, svgf_pipeline
from tpuray_torch.integrator.gather_tables import PackedScene, pack_scene_tables
from tpuray_torch.integrator.gbuffer import GBuffer, build_gbuffer
from tpuray_torch.integrator.path_tracer import (
    KERNELS, Tracer, check_config, pack_traversal, resolve_aniso, trace_paths)
from tpuray_torch.kernels.trace import TraceTables
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.render.tiling import tile_pixel_coords, untile
from tpuray_torch.scene.config import DebugView, RenderConfig
from tpuray_torch.scene.types import Camera
from tpuray_torch.utils.metrics import FRAME, count, span

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
    return pixel_rays(camera, height, width,
                      *tile_pixel_coords(height, width, camera.eye.device))


def pixel_rays(camera: Camera, height: int, width: int, xx: Tensor, yy: Tensor
               ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The primary rays of pixels (xx, yy) (int32, row 0 the top row), in
    their order -> (orig (N, 3) view, d (N, 3), px, py)."""
    d = camera.pixel_directions(height, width, xx, yy)
    orig = camera.eye.expand(xx.shape[0], 3)
    return orig, d, xx, height - 1 - yy


def still_camera(device: torch.device, frame_idx: int, view_proj: np.ndarray,
                 prev_view_proj: np.ndarray) -> bool:
    """Whether a frame takes the denoiser's static-camera specialisation:
    the view unchanged since an earlier frame, off the card only, as tpuray
    takes it only off its own device (tpuray/render/renderer.py:186-196).
    Its semantics are the moving path's with zero motion, so on the card a
    still frame runs K4 as a moving one does."""
    return bool(device.type != "cuda" and frame_idx > 0
                and np.allclose(view_proj, prev_view_proj))


def render_frame(scene, camera: Camera, state: FrameState, cfg: RenderConfig,
                 height: int, width: int,
                 tracer: Tracer = KERNELS,
                 tables: TraceTables | None = None,
                 pk: PackedScene | None = None,
                 static_camera: bool = False
                 ) -> tuple[FrameState, FrameOutputs]:
    """Render one frame and advance the temporal state.

    static_camera=True takes the denoiser's static-camera specialisation
    (motion == 0): its plain branch off the card, K4 at zero motion under
    cfg.pallas_denoise on it; the Renderer selects it by still_camera.
    Differentiable with enable_svgf=False, or with pallas_denoise=False
    (K4 and K5 are forward-only and raise under grad)."""
    frame = state.frame_idx
    orig, d, px, py = camera_rays(camera, height, width)
    pt = trace_paths(scene, orig, d, px, py, frame, cfg, common_origin=True,
                     tracer=tracer, tables=tables, pk=pk)

    emission = untile(pt.emission, height, width)
    albedo = untile(pt.albedo, height, width)
    accum = pt_color = accumulate(state, untile(pt.color, height, width), cfg)

    gbuf = build_gbuffer(
        point=untile(pt.first_hit_point, height, width),
        normal=untile(pt.first_hit_normal, height, width),
        valid=untile(pt.first_hit_valid, height, width),
        view_proj=camera.view_proj, prev_view_proj=state.prev_view_proj)

    new_state, svgf, final = denoise_and_advance(
        state, camera, cfg, pt_color, accum, emission, albedo, gbuf, static_camera)
    outputs = FrameOutputs(
        pt_color=pt_color, accum_color=accum, svgf=svgf, gbuffer=gbuf,
        final=final,
        coverage=torch.mean(pt.first_hit_valid.to(torch.float32)))
    count("coverage", outputs.coverage)
    return new_state, outputs


def accumulate(state: FrameState, color: Tensor, cfg: RenderConfig) -> Tensor:
    """The progressive running mean of the frames' colors (cfg.accumulate),
    else this frame's."""
    if not cfg.accumulate:
        return color
    t = float(np.float32(1.0) / (np.float32(state.frame_idx) + np.float32(1.0)))
    return state.accum_color + (color - state.accum_color) * t


def denoise_and_advance(state: FrameState, camera: Camera, cfg: RenderConfig,
                        pt_color: Tensor, accum: Tensor, emission: Tensor,
                        albedo: Tensor, gbuf: GBuffer, static_camera: bool = False,
                        rows: ImageRows = WHOLE_IMAGE
                        ) -> tuple[FrameState, SVGFOutput, Tensor]:
    """A frame's denoiser and state update from its traced images ->
    (new_state, svgf, final). rows: svgf_pipeline's, the whole image or a
    row shard (dist/frame.py); K4 and K5 under cfg.pallas_denoise."""
    frame = state.frame_idx
    if cfg.enable_svgf:
        svgf = svgf_pipeline(pt_color, emission, albedo, gbuf, state, cfg,
                             static_camera=static_camera, rows=rows)
        final = svgf.taa if cfg.enable_taa else svgf.modulated
        new_state = state.replace(
            illum_hist=svgf.history_tap, variance_hist=svgf.history_tap_var,
            prev_normal=gbuf.normal, prev_linear_z=gbuf.linear_z,
            moments=svgf.moments, history_len=svgf.history_len,
            accum_color=accum, taa_color=svgf.taa, frame_idx=frame + 1,
            prev_view_proj=camera.view_proj)
    else:
        z1 = torch.zeros(pt_color.shape[:2], dtype=torch.float32,
                         device=pt_color.device)
        svgf = SVGFOutput(
            reprojected=pt_color, reprojected_var=z1, variance_illum=pt_color,
            variance_var=z1, atrous=pt_color, atrous_var=z1,
            history_tap=pt_color, history_tap_var=z1, modulated=pt_color,
            taa=pt_color,
            moments=torch.zeros((*pt_color.shape[:2], 2), dtype=torch.float32,
                                device=pt_color.device),
            history_len=z1)
        final = pt_color
        new_state = state.replace(
            prev_normal=gbuf.normal, prev_linear_z=gbuf.linear_z,
            accum_color=accum, taa_color=final, frame_idx=frame + 1,
            prev_view_proj=camera.view_proj)
    return new_state, svgf, final


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


class LaggedScalar:
    """A device scalar copied to the host behind the work queued so far, to
    be read later without waiting: on a CUDA device an asynchronous copy
    into pinned memory behind a recorded event (.item() would wait for the
    whole stream), on the CPU the value itself."""

    def __init__(self, x: Tensor):
        if x.device.type == "cuda":
            self._host = torch.empty((), dtype=x.dtype, pin_memory=True)
            self._host.copy_(x, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = x.detach().clone(), None

    def read(self) -> float:
        """The value; waits only if the copy has not landed yet."""
        with span("tpuray.wait.coverage"):
            if self._event is not None:
                self._event.synchronize()
            return float(self._host)


class Renderer:
    """Owns the scene (on `device`), its packed tables (a forest's for K6 or
    a single tree's), the config and the temporal state, and drives frames.

    With cfg.compact_auto, frames start at cfg.compact_frac; every
    _TUNE_EVERY frames the Renderer reads the coverage copied a period
    earlier and sets the budget of the frames after it to the smallest
    bucket that holds the coverage with 30% headroom, or to no compaction
    (tpuray/render/renderer.py:145-183). frame_cfg is the config the next
    frame renders with: cfg with the current bucket. Assigning cfg (the
    viewer's sliders do) takes effect at the next step() and keeps the
    bucket; the JAX package keeps rendering its old config under
    compact_auto until the bucket next changes (ROADMAP.md section 3).

    device defaults to "cuda"; without a CUDA device the Renderer raises
    unless it is given device="cpu". Cameras may be built anywhere: step()
    moves them to the Renderer's device, and chooses the static-camera
    branch (still_camera) from a host copy of the view matrix (a camera
    built on the host, as OrbitCamera.snapshot() does by default, costs no
    device read)."""

    _BUCKETS = (0.125, 0.25, 0.5)
    _HEADROOM = 1.3
    _TUNE_EVERY = 8  # frames between coverage reads

    def __init__(self, scene, cfg: RenderConfig, device="cuda",
                 tracer: Tracer = KERNELS):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Renderer: no CUDA device is available; pass device='cpu' "
                "to render on the CPU")
        self.scene = scene.to(device)
        self._bucket = cfg.compact_frac  # compact_auto's current budget
        self.cfg = cfg
        self.device = self.scene.triangles.p0.device
        self.tracer = tracer
        with torch.no_grad():  # serving keeps no graph, even of trainable tables
            self.tables = pack_traversal(self.scene)
            self.pk = pack_scene_tables(self.scene)
        self.state = FrameState.initial(cfg.height, cfg.width, self.device)
        self._prev_view_proj = np.eye(4, dtype=np.float32)  # host copy
        self.last_outputs: FrameOutputs | None = None
        self._steps = 0
        self._pending_cov: LaggedScalar | None = None

    @property
    def cfg(self) -> RenderConfig:
        return self._cfg

    @cfg.setter
    def cfg(self, cfg: RenderConfig) -> None:
        """Check cfg and set it, with enable_aniso="auto" resolved on the
        scene; the next frame renders with it (frame_cfg)."""
        check_config(cfg)
        if cfg.enable_svgf:
            gather_mode(cfg)
        if cfg.enable_aniso == "auto":
            cfg = dataclasses.replace(cfg, enable_aniso=resolve_aniso(self.scene, cfg))
        self._cfg = cfg

    @property
    def frame_cfg(self) -> RenderConfig:
        """The config of the next frame: cfg, in the current compaction
        bucket when cfg.compact_auto is on."""
        if self._cfg.compact_auto:
            return dataclasses.replace(self._cfg, compact_frac=self._bucket)
        return self._cfg

    def reset(self) -> None:
        self.state = self.state.reset_accumulation()

    def restore(self, state: FrameState) -> None:
        """Continue from a saved FrameState (utils/checkpoint.py)."""
        self.state = state
        self._prev_view_proj = state.prev_view_proj.detach().cpu().numpy()

    def _tune_compaction(self, out: FrameOutputs) -> None:
        """Every _TUNE_EVERY frames: set the bucket from the coverage copied
        a period ago, and copy this frame's. A stale bucket costs speed
        only: the residual pass keeps overflowing frames exact."""
        self._steps += 1
        if self._steps % self._TUNE_EVERY:
            return
        if self._pending_cov is not None:
            want = self._pending_cov.read() * self._HEADROOM
            self._bucket = next((b for b in self._BUCKETS if b >= want), 0.0)
        self._pending_cov = LaggedScalar(out.coverage)

    @torch.no_grad()
    def step(self, camera: Camera) -> FrameOutputs:
        """Render the next frame. Serving builds no autograd graph, whatever
        the scene's tensors require (render_frame differentiates)."""
        with span(FRAME):
            view_proj = camera.view_proj.detach().cpu().numpy()
            static = still_camera(self.device, self.state.frame_idx, view_proj,
                                  self._prev_view_proj)
            self.state, out = render_frame(
                self.scene, camera.to(self.device), self.state, self.frame_cfg,
                self.cfg.height, self.cfg.width, tracer=self.tracer,
                tables=self.tables, pk=self.pk, static_camera=static)
            self._prev_view_proj = view_proj
            self.last_outputs = out
            if self.cfg.compact_auto:
                self._tune_compaction(out)
            return out

    def render(self, camera: Camera, n_frames: int = 1) -> FrameOutputs:
        out = None
        for _ in range(n_frames):
            out = self.step(camera)
        return out

    def display_image(self, view: DebugView = DebugView.FINAL) -> np.ndarray:
        img = select_debug_view(self.last_outputs, view)
        return tonemap(img, self.cfg.tonemap_limit, self.cfg.gamma).cpu().numpy()
