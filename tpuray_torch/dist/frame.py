"""Fully sharded frame: path trace + SVGF + TAA with image rows split across
the ranks (counterpart of tpuray/dist/frame.py).

`dist.sharding.render_tiled` shards only the path tracing. This module runs
the whole frame (trace, G-buffer, temporal reprojection, spatial variance,
the a-trous chain, modulate, TAA, the state update) on this rank's rows,
with the scene replicated. The denoise stages are stencils: before each
stage the rank extends its shard with the rows it needs from its
neighbours (point-to-point sends, `_halo_rows`), computes on the extended
shard with global-coordinate bounds masks (the `row_window` argument of
denoise/* and of K4 and K5) and crops, so the result is the single-device
frame. The frame is render_frame's own sequence, from the same functions:
dist/sharding.py:trace_rows on the rank's rows, then
render/renderer.py:denoiser_inputs and denoise_and_advance
(denoise/svgf.py:svgf_pipeline with this module's ShardRows); a world of
one holds the whole image and exchanges nothing.

Temporal reprojection can read arbitrarily far rows under fast motion; the
halo bounds it: a pixel whose history taps lie farther than `halo` rows
from the shard fails its reprojection (the algorithm's response to a
disocclusion), and TAA rejects such a pixel's history. K4 reaches halo + 3
rows, since it reprojects the variance fallback's 3 rows past the shard
itself where the plain stages take them from the neighbour: the two
denoisers differ only where the taps travel farther than the halo
(ROADMAP.md §3). `halo` also caps the a-trous exchange, so it must be
>= 2 * the largest dilation step.

The moving camera's history read follows the config
(denoise/reproject.py:history_read). Under reproject_gather="tiled" it is
tpuray's sharded read: the tile-windowed fetch (denoise/tile_gather.py) on
each stage's extended rows, in reproject and in TAA, as
tpuray/dist/frame.py:150-205 runs it; fast_reproject reads the same on a
shard (tpuray's sharded stage has no shifted rescue). Under "auto" and
"exact" the port keeps its exact read, where tpuray's sharded frame reads
tile-windowed whatever the config (ROADMAP.md §3: a known divergence of
"auto"); so the exact read's sharded frame equals the port's single-device
frame (render/renderer.py:render_frame under the same config) bit for bit
at any world size wherever the motion stays inside the halo. Under
cfg.pallas_denoise (the default) each rank runs K4 once on its rows
extended by halo + 3 and K5 once per a-trous iteration, a halo exchanged
before each; otherwise the plain stages, as tpuray's sharded frame runs
XLA's stencils. Under the tiled read K4 runs on the rows extended by the
halo alone, in their tiles, as the plain reproject does; it reprojects
the 3 rows past the shard that its fallback reads in its tiles, where the
neighbour reads them in its own: the kernel denoiser's sharded frame can
differ from the plain stages' in the fallback of the pixels within 3 rows
of a shard's edge (ROADMAP.md §3).

Primary rays are row-major per shard with global pixel coordinates, so the
RNG streams are the single-device frame's. Under compaction each rank ranks
and budgets its own hits (path_tracer.select_hits).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from tpuray_torch.denoise.svgf import WHOLE_IMAGE, ImageRows
from tpuray_torch.dist.sharding import Mesh, gather_rows, shard_rays, trace_rows
from tpuray_torch.integrator.gather_tables import PackedScene
from tpuray_torch.integrator.path_tracer import KERNELS, Tracer, check_config
from tpuray_torch.kernels.trace import TraceTables
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.render.renderer import denoise_and_advance, denoiser_inputs
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.types import Camera
from tpuray_torch.utils.metrics import FRAME, span

Tensor = torch.Tensor

# FrameState fields that are (H, W, ...) images, sharded by rows; frame_idx
# (a host int) and prev_view_proj are replicated
STATE_IMG_FIELDS = ("illum_hist", "variance_hist", "prev_normal",
                    "prev_linear_z", "moments", "history_len",
                    "accum_color", "taa_color")


def _exchange(mesh: Mesh, buf: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """(the k rows above the shard, the k rows below it) from the
    neighbouring ranks: every rank posts all its sends and receives at
    once (batch_isend_irecv), so no order of the ranks can deadlock."""
    above = torch.empty_like(buf[:k])
    below = torch.empty_like(buf[:k])
    ops = []
    if mesh.rank > 0:
        peer = mesh.global_rank(mesh.rank - 1)
        ops += [dist.P2POp(dist.isend, buf[:k].contiguous(), peer, mesh.group),
                dist.P2POp(dist.irecv, above, peer, mesh.group)]
    if mesh.rank < mesh.size - 1:
        peer = mesh.global_rank(mesh.rank + 1)
        ops += [dist.P2POp(dist.isend, buf[-k:].contiguous(), peer, mesh.group),
                dist.P2POp(dist.irecv, below, peer, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return above, below


def _halo_rows(mesh: Mesh, k: int, *xs: Tensor) -> tuple[Tensor, ...]:
    """Each (rows, W, ...) float32 shard extended with k rows from each
    neighbour, all in one exchange. The first and last ranks replicate
    their own edge row instead (clamp-to-edge, what the single-device
    stencils read past the image border via denoise.common.shift2d). The
    outputs are contiguous: a channel slice of the packed buffer would send
    every op of the stage after it down PyTorch's strided kernels."""
    rows, w = xs[0].shape[:2]
    flat = [x.reshape(rows, w, -1) for x in xs]
    buf = torch.cat(flat, dim=-1)
    top = buf[:1].expand(k, *buf.shape[1:])
    bot = buf[-1:].expand(k, *buf.shape[1:])
    if mesh.size > 1:
        above, below = _exchange(mesh, buf, k)
        top = above if mesh.rank > 0 else top
        bot = below if mesh.rank < mesh.size - 1 else bot
    ext = torch.cat([top, buf, bot], dim=0)
    out, c0 = [], 0
    for x, f in zip(xs, flat):
        c = f.shape[-1]
        out.append(ext[..., c0:c0 + c].reshape(rows + 2 * k, *x.shape[1:]).contiguous())
        c0 += c
    return tuple(out)


class ShardRows(ImageRows):
    """This rank's rows of the frame for denoise/svgf.py:svgf_pipeline: a
    stage's inputs extended by the neighbours' rows (_halo_rows), the
    global row window, the halo cropped again."""

    def __init__(self, mesh: Mesh, row0: int, height: int, halo: int):
        self.mesh, self.row0, self.height, self.halo = mesh, row0, height, halo

    def extend(self, k, *xs):
        return _halo_rows(self.mesh, k, *xs)

    def narrow(self, x, have, k):
        return x[have - k:x.shape[0] - (have - k)]

    def window(self, k):
        return (self.row0 - k, self.height)

    def crop(self, x, k):
        return x[k:-k] if k else x


def _check_layout(height: int, mesh: Mesh, cfg: RenderConfig, halo: int) -> int:
    """The shard's rows; raises where the halo exchange cannot hold the
    single-device frame."""
    n = mesh.size
    if height % n:
        raise ValueError(f"height {height} is not a multiple of {n} ranks")
    rows = height // n
    if rows % 2:
        raise ValueError("shard rows must be even (the G-buffer's 2x2 quads)")
    max_step = 1 << max(cfg.num_atrous_iterations - 1, 0)
    if halo < max(2 * max_step, 4):
        raise ValueError(f"halo {halo} < 2 * the largest a-trous step {2 * max_step}")
    if halo > rows:
        raise ValueError(f"halo {halo} > shard rows {rows}")
    if cfg.enable_svgf and cfg.pallas_denoise and halo + 3 > rows:
        raise ValueError(f"K4's reach, halo {halo} + 3 for the variance fallback, exceeds "
                         f"shard rows {rows}")
    if 2 * max_step + 1 > rows:
        raise ValueError(f"a-trous halo {2 * max_step + 1} exceeds shard rows {rows}; "
                         "use fewer ranks, a taller image or fewer iterations")
    return rows


def render_frame_sharded(scene, camera: Camera, state: FrameState,
                         cfg: RenderConfig, height: int, width: int,
                         mesh: Mesh, halo: int = 32,
                         static_camera: bool = False,
                         tracer: Tracer = KERNELS,
                         tables: TraceTables | None = None,
                         pk: PackedScene | None = None
                         ) -> tuple[FrameState, Tensor, Tensor]:
    """One full frame on this rank's rows -> (new_state, final, pt_color).

    state is this rank's shard (shard_state); new_state's image fields,
    final and pt_color are (H / world size, W, ...) row shards, frame_idx
    and prev_view_proj replicated. Every rank calls it with the same
    arguments. scene, tables and pk live on mesh.device (pack them once:
    pack_traversal, pack_scene_tables). The denoiser runs K4 and K5 on
    this rank's rows under cfg.pallas_denoise, the plain stages otherwise;
    static_camera as render_frame's (on the card K4 at zero motion)."""
    with span(FRAME):
        check_config(cfg)
        rows = _check_layout(height, mesh, cfg, halo)
        row0 = mesh.rank * rows
        scene, camera = scene.to(mesh.device), camera.to(mesh.device)
        # shard_rays, denoise_and_advance: read per call (portbench/ replaces both)
        pt = trace_rows(scene, camera, cfg, height, width, row0, rows, state.frame_idx,
                        tracer, tables, pk, rays=shard_rays)
        # shard rows and row0 are even: no 2x2 quad straddles two shards
        inputs = denoiser_inputs(pt, state, camera, cfg,
                                 lambda x: x.reshape(rows, width, *x.shape[1:]))
        # a world of one holds the whole image: nothing to exchange
        image_rows = ShardRows(mesh, row0, height, halo) if mesh.size > 1 else WHOLE_IMAGE
        new_state, _, final = denoise_and_advance(state, camera, cfg, *inputs, static_camera,
                                                  rows=image_rows)
        return new_state, final, inputs[0]


def shard_state(state: FrameState, mesh: Mesh) -> FrameState:
    """This rank's rows of a full-image FrameState, on mesh.device; the
    bookkeeping replicated."""
    height = state.illum_hist.shape[0]
    if height % mesh.size:
        raise ValueError(f"height {height} is not a multiple of {mesh.size} ranks")
    rows = height // mesh.size
    lo = mesh.rank * rows
    kw = {f: getattr(state, f)[lo:lo + rows].to(mesh.device).contiguous()
          for f in STATE_IMG_FIELDS}
    return state.replace(prev_view_proj=state.prev_view_proj.to(mesh.device), **kw)


def gather_state(state: FrameState, mesh: Mesh) -> FrameState:
    """The full-image FrameState on every rank (each image field
    all-gathered), as a checkpoint saves it."""
    return state.replace(**{f: gather_rows(mesh, getattr(state, f))
                            for f in STATE_IMG_FIELDS})
