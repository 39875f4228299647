"""K4: SVGF reprojection + spatial variance fallback (reproject_variance_fused).

Counterpart of tpuray/kernels/reproject_pallas.py. The CUDA kernel lives
in csrc/reproject.cu (see its header for the design: one launch; a block
whose pixels need the variance fallback reprojects a halo of 3 into a
shared-memory tile and filters from it). It computes reproject followed
by estimate_variance, with the history read of
denoise/reproject.py:history_read(cfg, row_window), a tap rule of the
kernel:
- "exact": the per-pixel read, reproject(reproject_gather="exact");
- "tiled" on the whole image: what the TPU kernel computes,
  reproject_pallas._kernel: the tile-windowed read in its geometry
  (32 x 128 tiles, a window offset taken over a halo of 4 and clipped to
  [-PY, hp]) on a block extended by 4, whose every reprojection, the
  variance fallback's 3 rows and columns past the tile included, takes
  the tile's window;
- "tiled" with a row window: tpuray's sharded stage, tile_gather's read
  (40 x 160 tiles, a halo of 1) on the shard's rows, each pixel in its own
  tile;
- "fast": the exact bilinear taps and the shifted rescue.
The tile-windowed rules take their windows from the wrapper, which
computes them with torch ops (tile_gather.window_offsets, as tpuray does
on its XLA side) and passes them as two (tiles down, tiles across) int32
tensors; a tap then reads the history directly wherever it resolves.

row_window=(row0, global_h): the inputs are a row shard of a taller image
extended by its neighbours' rows (dist/frame.py); both the kernel and its
plain version take the window as the plain stages do (reproject's in_shard,
the global bounds masks), on the same extended rows. Under the tiled read
the window's rows are the image of the read and its tiles start at the
window's first row, as in tpuray's sharded stage; svgf_pipeline then gives
K4 the plain stage's rows (the tiled read never leaves them, and the
fallback's 3 rows past the shard lie inside the halo).

The wrapper
- raises if an input requires grad (forward only, as the JAX package's
  kernel; pallas_denoise=False runs the plain stages, which differentiate);
- runs the plain version when its tensors lie on the CPU;
- on CUDA tensors, checks device, dtype, shape and contiguity, allocates
  the six outputs, launches the kernel on the current stream, raises if
  the launch failed, and adds one to LAUNCHES["k4"]. There is no fallback.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpuray_torch.denoise import tile_gather as tg
from tpuray_torch.denoise.common import squarings
from tpuray_torch.denoise.history_atlas import build_atlas
from tpuray_torch.denoise.reproject import (
    RING, BackProjection, back_project, demodulate, gather_mode, history_read,
    nearest_corner, reproject, tiled_history)
from tpuray_torch.denoise.variance import estimate_variance, fallback
from tpuray_torch.kernels import build
from tpuray_torch.scene.config import RenderConfig

Tensor = torch.Tensor

# kernel launches since the last reset (the plain path never counts)
LAUNCHES = {"k4": 0}

NO_GRAD_HINT = ("RenderConfig(pallas_denoise=False) runs the plain denoiser "
                "stages, which carry the gradient")


def reset_launches() -> None:
    LAUNCHES["k4"] = 0


class FusedOutput(NamedTuple):
    rep_illum: Tensor     # (H, W, 3) reprojected illumination (pre-fallback)
    rep_variance: Tensor  # (H, W)
    var_illum: Tensor     # (H, W, 3) after the spatial variance fallback
    var_variance: Tensor  # (H, W)
    moments: Tensor       # (H, W, 2)
    history_len: Tensor   # (H, W)


# (name, channels) of the inputs, in the C function's order
_INPUTS = (("color", 3), ("emission", 3), ("albedo", 3), ("motion", 2),
           ("normal", 3), ("linear_z", 1), ("fwidth_normal", 1),
           ("fwidth_z", 1), ("prev_illum", 3), ("prev_variance", 1),
           ("prev_normal", 3), ("prev_linear_z", 1), ("prev_moments", 2),
           ("prev_history_len", 1))
# their names: reproject's positional order
INPUT_NAMES = tuple(n for n, _ in _INPUTS)

# the TPU kernel's geometry (tpuray/kernels/reproject_pallas.py:49-60): tiles,
# the extended block's halo (1 ring tap + the fallback's 3), the residual
# span and the atlas guard pads that clip the window base
TY, TX, HALO, SPAN = 32, 128, 4, 4
PY, PX = 56, 384
# the C entry's tap rules
_RULES = {"exact": 0, "tiled": 1, "tiled_rows": 2, "fast": 3}


class Tiles(NamedTuple):
    """The window offsets of a tile-windowed rule."""
    rule: str        # "tiled" (the TPU kernel's geometry) or "tiled_rows"
    oy: Tensor       # (tiles down, tiles across) int32
    ox: Tensor
    ty: int          # the tile
    tx: int
    span: int


def tiles(cfg: RenderConfig, motion: Tensor,
          row_window: tuple[int, int] | None) -> Tiles | None:
    """The tile-windowed rule's windows for K4 and its plain version, or
    None under the exact and fast reads."""
    if history_read(cfg, row_window) != "tiled":
        return None
    lh, w = motion.shape[:2]
    if row_window is None:
        b = back_project(motion, 0, lh, w, cfg)
        hp, wp = -(-lh // TY) * TY, -(-w // TX) * TX
        oy, ox = tg.window_offsets(b.y0i, b.x0i, TY, TX, HALO, (-PY, hp), (-PX, wp))
        return Tiles("tiled", oy, ox, TY, TX, SPAN)
    row0, gh = row_window
    ty, tx, span = tg.DEFAULT_TY, tg.DEFAULT_TX, tg.DEFAULT_SPAN
    b = back_project(motion, row0, gh, w, cfg)
    oy, ox = tg.window_offsets(b.y0i - row0, b.x0i, ty, tx, 1,
                               (-(ty + span + 2), lh), (-(tx + span + 2), w))
    return Tiles("tiled_rows", oy, ox, ty, tx, span)


def reproject_variance_plain(cfg: RenderConfig, static_camera: bool = False,
                             row_window: tuple[int, int] | None = None,
                             **inputs: Tensor) -> FusedOutput:
    """K4's function in plain PyTorch: reproject with the history read of
    history_read(cfg, row_window), then estimate_variance, both with
    row_window on the same rows; the tiled read on the whole image is the
    TPU kernel's (_tpu_kernel_plain). static_camera takes the static
    specialisation (motion ignored), which has no kernel."""
    if not static_camera and row_window is None and gather_mode(cfg) == "tiled":
        return _tpu_kernel_plain(cfg, tiles(cfg, inputs["motion"], None), **inputs)
    rep = reproject(**inputs, cfg=cfg, static_camera=static_camera, row_window=row_window)
    var = estimate_variance(
        illum=rep.illum, variance=rep.variance, moments=rep.moments,
        history_len=rep.history_len, normal=inputs["normal"],
        linear_z=inputs["linear_z"], fwidth_z=inputs["fwidth_z"], cfg=cfg,
        row_window=row_window)
    return FusedOutput(rep_illum=rep.illum, rep_variance=rep.variance,
                       var_illum=var.illum, var_variance=var.variance,
                       moments=rep.moments, history_len=rep.history_len)


def _tpu_kernel_plain(cfg, t: Tiles, **x) -> FusedOutput:
    """What reproject_pallas._kernel computes, tile by tile: each tile's
    block extended by HALO (and one more for the ring taps), its cells past
    the image reading the edge pixel's inputs with the base tap moved by as
    much (the kernel's edge-padded planes), every cell reprojected with the
    tile's window, then the fallback of the tile's pixels from the block."""
    h, w = x["color"].shape[:2]
    dev = x["color"].device
    nty, ntx = t.oy.shape
    eh, ew = TY + 2 * HALO, TX + 2 * HALO
    ry = (torch.arange(nty, device=dev) * TY)[:, None] - HALO - 1 \
        + torch.arange(eh + 2, device=dev)[None]                     # (nty, eh + 2)
    rx = (torch.arange(ntx, device=dev) * TX)[:, None] - HALO - 1 \
        + torch.arange(ew + 2, device=dev)[None]                     # (ntx, ew + 2)
    cy, cx = torch.clamp(ry, 0, h - 1), torch.clamp(rx, 0, w - 1)

    def block(a):  # (h, w, ...) -> (nty, ntx, eh + 2, ew + 2, ...)
        return a[cy][:, :, cx].movedim(2, 1)

    def inner(a):
        return a[:, :, 1:-1, 1:-1]

    b = back_project(x["motion"], 0, h, w, cfg)
    near_y, near_x = nearest_corner(b, h, w)
    gy, gx = ry[:, None, :, None], rx[None, :, None, :]
    y0 = block(b.y0i) - cy[:, None, :, None] + gy      # the moved base taps
    x0 = block(b.x0i) - cx[None, :, None, :] + gx
    rg = torch.clamp(y0, 0, h - 1) - gy
    cg = torch.clamp(x0, 0, w - 1) - gx
    yy, xx = gy[:, :, 1:-1], gx[..., 1:-1]  # the inner cells' rows and columns
    res = tg.resolve(rg, cg, yy, xx, h, w, t.oy[:, :, None, None],
                     t.ox[:, :, None, None], RING, SPAN)
    atlas = build_atlas(x["prev_illum"], x["prev_variance"], x["prev_normal"],
                        x["prev_linear_z"], x["prev_moments"], x["prev_history_len"])
    f = {k: inner(block(x[k])) for k in (
        "color", "emission", "albedo", "normal", "linear_z", "fwidth_normal", "fwidth_z",
        "prev_moments", "prev_history_len")}
    eb = BackProjection(None, None, inner(x0), inner(y0), inner(block(b.frac_x)),
                        inner(block(b.frac_y)))
    rep = tiled_history(
        f["color"], demodulate(f["color"], f["emission"], f["albedo"]), f["normal"],
        f["linear_z"], f["fwidth_normal"], f["fwidth_z"], eb, inner(block(near_y)),
        inner(block(near_x)), {e: tg.fetch(atlas, r[1], r[2], r[3]) for e, r in res.items()},
        {e: r[0] for e, r in res.items()}, f["prev_moments"], f["prev_history_len"], h, w, cfg)

    # the fallback of the tile's pixels, reading the block's reprojections
    def ctr(a, dy=0, dx=0):
        return a[:, :, HALO + dy:HALO + dy + TY, HALO + dx:HALO + dx + TX]

    def tap(dy, dx):
        ys = yy[:, :, HALO + dy:HALO + dy + TY]
        xs = xx[..., HALO + dx:HALO + dx + TX]
        inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        return (ctr(rep.illum, dy, dx), ctr(rep.moments, dy, dx),
                ctr(f["linear_z"], dy, dx), ctr(f["normal"], dy, dx), inside)

    var = fallback(ctr(rep.illum), ctr(rep.variance), ctr(rep.moments),
                   ctr(rep.history_len), ctr(f["normal"]), ctr(f["linear_z"]),
                   ctr(f["fwidth_z"]), cfg, tap)

    def image(a):  # (nty, ntx, TY, TX, ...) -> (h, w, ...)
        return a.movedim(2, 1).reshape(nty * TY, ntx * TX, *a.shape[4:])[:h, :w]

    return FusedOutput(rep_illum=image(ctr(rep.illum)), rep_variance=image(ctr(rep.variance)),
                       var_illum=image(var.illum), var_variance=image(var.variance),
                       moments=image(ctr(rep.moments)),
                       history_len=image(ctr(rep.history_len)))


def reproject_variance_fused(cfg: RenderConfig,
                             row_window: tuple[int, int] | None = None,
                             **inputs: Tensor) -> FusedOutput:
    """Moving-camera reproject + spatial-variance fallback.

    Keyword inputs as reproject's (color, emission, albedo, motion, normal,
    linear_z, fwidth_normal, fwidth_z, prev_illum, prev_variance,
    prev_normal, prev_linear_z, prev_moments, prev_history_len), each
    (H, W) or (H, W, C) float32; row_window as the module says.
    Returns the six FusedOutput fields."""
    read = history_read(cfg, row_window)
    if set(inputs) != set(INPUT_NAMES):
        raise TypeError(f"reproject_variance_fused takes {list(INPUT_NAMES)}")
    build.refuse_grad("reproject_variance_fused (K4)", NO_GRAD_HINT,
                      *inputs.values())
    color = inputs["color"]
    if color.device.type == "cpu":
        return reproject_variance_plain(cfg, row_window=row_window, **inputs)
    if color.device.type != "cuda":
        raise ValueError(f"reproject_variance_fused: unsupported device {color.device}")
    dev = color.device
    h, w = color.shape[:2]
    row0, global_h = row_window if row_window is not None else (0, h)
    if h < 2 or w < 2 or global_h < 2:
        raise ValueError(f"K4 needs an image of at least 2x2, got {h}x{w} of {global_h} rows")
    for name, c in _INPUTS:
        build.check(inputs[name], name, torch.float32,
                    (h, w) if c == 1 else (h, w, c), dev)
    t = tiles(cfg, inputs["motion"], row_window)
    rule = _RULES[read if t is None else t.rule]
    if t is None:
        t = Tiles(read, None, None, 1, 1, 0)

    def empty(*c):
        return torch.empty((h, w, *c), dtype=torch.float32, device=dev)

    out = FusedOutput(rep_illum=empty(3), rep_variance=empty(),
                      var_illum=empty(3), var_variance=empty(),
                      moments=empty(2), history_len=empty())
    n_sq = squarings(cfg.sigma_n)
    f = ctypes.c_float
    with torch.cuda.device(dev):
        rc = build.load().tpuray_reproject_variance(
            *[inputs[n].data_ptr() for n, _ in _INPUTS],
            out.rep_illum.data_ptr(), out.rep_variance.data_ptr(),
            out.moments.data_ptr(), out.history_len.data_ptr(),
            out.var_illum.data_ptr(), out.var_variance.data_ptr(),
            h, w, row0, global_h, f(cfg.reproj_depth_threshold), f(cfg.reproj_normal_threshold),
            f(cfg.history_cap), f(cfg.alpha_min), f(cfg.sigma_n),
            -1 if n_sq is None else n_sq, f(cfg.sigma_l),
            int(cfg.reference_quirks), rule,
            None if t.oy is None else t.oy.data_ptr(),
            None if t.ox is None else t.ox.data_ptr(),
            1 if t.oy is None else t.oy.shape[0], 1 if t.ox is None else t.ox.shape[1],
            t.ty, t.tx, t.span,
            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(rc, "reproject_variance_fused (K4)")
    LAUNCHES["k4"] += 1
    return out
