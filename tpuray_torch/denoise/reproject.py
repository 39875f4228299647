"""SVGF temporal reprojection (counterpart of tpuray/denoise/reproject.py,
shaders/svgf_reproject.frag).

Demodulate the 1spp color, back-project by the motion vectors, validate the
4 bilinear history taps against depth and normal consistency, take a 3x3
cross-bilateral rescue where all fail, then an EMA of illumination and
luminance moments with history-length control.

The moving camera's history read is tpuray's, by gather_mode(cfg):
- "exact" (reproject_gather "auto" or "exact"): per-pixel reads, the
  plain version of K4's exact instance (kernels/reproject.py);
- "tiled": the tile-windowed read (denoise/tile_gather.py): the 9 taps
  around the clipped base, each dropped where the read does not resolve
  it (motion discontinuities, the border, a tile's span overflow);
- "fast" (fast_reproject=True): the exact bilinear taps, and a rescue
  whose tap (dy, dx) is the base tap of the pixel (y + dy, x + dx), edge
  clamped.
With a row window the read is "tiled" under fast_reproject too: tpuray's
sharded stage has no shifted rescue (history_read). Then the static-
camera specialisation.

The clamps of the JAX package's quad-packed history fetch are repeated
here, not fixed:
- the 4 bilinear taps of the exact and fast reads come from one 2x2 quad
  at the clamped base (clamp(y0), clamp(x0)), whose right/down neighbours
  clamp at the last row and column: where x0 = -1, taps 0 and 1 read
  texels 0 and 1. Their validity uses the unclamped x0 + dx, y0 + dy;
- the exact rescue's taps come from 4 quads at bases clamped to
  [0, dim - 2], with the in-window and first-quad-owns masks, so at the
  border an edge tap can be counted twice. The tiled rescue reads the 9
  taps around the clipped base and drops those past the image.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpuray_torch.denoise.common import (
    inside_mask, luminance, norm3, rdiv, shift2d)
from tpuray_torch.denoise.history_atlas import HIST as _HL
from tpuray_torch.denoise.history_atlas import IV as _IV
from tpuray_torch.denoise.history_atlas import MOMENTS as _M
from tpuray_torch.denoise.history_atlas import NORMAL as _N
from tpuray_torch.denoise.history_atlas import Z as _Z
from tpuray_torch.denoise.history_atlas import build_atlas
from tpuray_torch.denoise.tile_gather import tiled_taps
from tpuray_torch.scene.config import RenderConfig

Tensor = torch.Tensor

_QUAD = ((0, 0), (1, 0), (0, 1), (1, 1))  # (dx, dy) of the bilinear taps
# (dy, dx) of the tiled read's bilinear taps, in the order they are summed,
# and of its rescue ring
QUAD_DYDX = ((0, 0), (0, 1), (1, 0), (1, 1))
RING = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
READS = ("exact", "tiled", "fast")


class ReprojectOutput(NamedTuple):
    illum: Tensor        # (H, W, 3) temporally accumulated illumination
    variance: Tensor     # (H, W)
    moments: Tensor      # (H, W, 2)
    history_len: Tensor  # (H, W)


def gather_mode(cfg: RenderConfig) -> str:
    """The moving-camera history read: "fast" under fast_reproject, else
    "exact" for reproject_gather "auto" and "exact", "tiled" for "tiled".
    "auto" is the exact read on every device: tpuray picks the tiled read
    on its TPU for the TPU's gather cost."""
    if cfg.reproject_gather not in ("auto", "exact", "tiled"):
        raise ValueError(f"unknown reproject_gather {cfg.reproject_gather!r}")
    if cfg.fast_reproject:
        return "fast"
    return "tiled" if cfg.reproject_gather == "tiled" else "exact"


def history_read(cfg: RenderConfig, row_window: tuple[int, int] | None = None) -> str:
    """gather_mode(cfg) on a row window: a row shard reads "tiled" under
    fast_reproject, as tpuray's sharded stage does (tpuray/denoise/
    reproject.py:86-90); the exact read keeps its own row window."""
    mode = gather_mode(cfg)
    return "tiled" if mode == "fast" and row_window is not None else mode


def demodulate(color: Tensor, emission: Tensor, albedo: Tensor) -> Tensor:
    """(color - emission) / max(albedo, 1e-3), NaN set to 0
    (svgf_reproject.frag:26-29, 174)."""
    illum = (color - emission) / torch.clamp_min(albedo, 1e-3)
    return torch.where(torch.isnan(illum), 0.0, illum)


def floor_mod(x: Tensor, d: float) -> Tensor:
    """x mod d with the sign of d (jnp.remainder): fmod, plus d where the
    truncated remainder is non-zero and of the other sign."""
    r = torch.fmod(x, d)
    return torch.where((r != 0) & ((r < 0) != (d < 0)), r + d, r)


class BackProjection(NamedTuple):
    fx: Tensor      # the float history position, pixel centres at i + 0.5
    fy: Tensor      # (image rows)
    x0i: Tensor     # its floor (int64), unclipped
    y0i: Tensor
    frac_x: Tensor  # the bilinear fractions
    frac_y: Tensor


def back_project(motion: Tensor, row0: int, h: int, w: int,
                 cfg: RenderConfig) -> BackProjection:
    """uv_prev = uv - motion of each pixel of the (rows, W) motion, local row
    i being image row row0 + i of h. The divisors are tensors: on the card
    PyTorch computes `t / scalar` as t * (1 / scalar), which can move
    floor(fx) off K4's IEEE division."""
    lh = motion.shape[0]
    dev = motion.device
    yy, xx = torch.meshgrid(torch.arange(lh, device=dev) + row0,
                            torch.arange(w, device=dev), indexing="ij")
    w_t = torch.full_like(motion[..., 0], w)
    h_t = torch.full_like(motion[..., 0], h)
    uv_x = (xx.to(torch.float32) + 0.5) / w_t - motion[..., 0]
    uv_y = (yy.to(torch.float32) + 0.5) / h_t - motion[..., 1]
    fx = uv_x * w - 0.5
    fy = uv_y * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    if cfg.reference_quirks:
        # frac in uv units (svgf_reproject.frag:84-85): tap 0 dominates
        frac_x = floor_mod(uv_x, 1.0 / w)
        frac_y = floor_mod(uv_y, 1.0 / h)
    else:
        frac_x = fx - x0
        frac_y = fy - y0
    return BackProjection(fx, fy, x0.to(torch.int64), y0.to(torch.int64), frac_x, frac_y)


def nearest_corner(b: BackProjection, h: int, w: int) -> tuple[Tensor, Tensor]:
    """(near_y, near_x): round(f) is the bilinear corner (near_y, near_x)
    of the clamped base (a clamped-index compare, as the clamped fetch)."""
    near_x = torch.clamp(torch.round(b.fx).to(torch.int64), 0, w - 1) \
        > torch.clamp(b.x0i, 0, w - 1)
    near_y = torch.clamp(torch.round(b.fy).to(torch.int64), 0, h - 1) \
        > torch.clamp(b.y0i, 0, h - 1)
    return near_y, near_x


def _tap_ok(z_cur, fw_z, n_cur, fw_n, tap, cfg):
    """isReprjValid's depth and normal tests against a history row."""
    depth_ok = (torch.abs(tap[..., _Z] - z_cur) / (fw_z + 1e-2)) \
        <= cfg.reproj_depth_threshold
    normal_ok = (norm3(n_cur - tap[..., _N]) / (fw_n + 1e-2)) \
        <= cfg.reproj_normal_threshold
    return depth_ok & normal_ok


def _tap_valid(yi, xi, h, w, z_cur, fw_z, n_cur, fw_n, tap, cfg):
    """isReprjValid (svgf_reproject.frag:31-43) against a history row."""
    in_b = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    return in_b & _tap_ok(z_cur, fw_z, n_cur, fw_n, tap, cfg)


def reproject(color: Tensor, emission: Tensor, albedo: Tensor,
              motion: Tensor, normal: Tensor, linear_z: Tensor,
              fwidth_normal: Tensor, fwidth_z: Tensor,
              prev_illum: Tensor, prev_variance: Tensor,
              prev_normal: Tensor, prev_linear_z: Tensor,
              prev_moments: Tensor, prev_history_len: Tensor,
              cfg: RenderConfig, static_camera: bool = False,
              row_window: tuple[int, int] | None = None) -> ReprojectOutput:
    """row_window=(row0, global_h): the inputs are a halo-extended row shard
    of a taller image (dist/frame.py). The pixel and uv arithmetic runs in
    global rows. The exact read takes a tap's local row as its global row
    - row0, and a pixel whose taps reach rows outside the shard fails its
    reprojection (the response to a disocclusion), so wherever every tap
    lies inside, the shard computes the single-device result. The tiled
    read runs tpuray's sharded stage: tile_gather on the shard's own rows,
    whose taps past the shard do not resolve."""
    if static_camera:
        return _reproject_static(
            color, emission, albedo, normal, linear_z, fwidth_normal,
            fwidth_z, prev_illum, prev_variance, prev_normal, prev_linear_z,
            prev_moments, prev_history_len, cfg, row_window)
    read = history_read(cfg, row_window)
    if read == "tiled":
        return _reproject_tiled(
            color, emission, albedo, motion, normal, linear_z, fwidth_normal,
            fwidth_z, prev_illum, prev_variance, prev_normal, prev_linear_z,
            prev_moments, prev_history_len, cfg, row_window)
    lh, w = color.shape[:2]  # local rows
    row0, h = row_window if row_window is not None else (0, lh)
    dev = color.device
    sky = linear_z == 1.0
    atlas = build_atlas(prev_illum, prev_variance, prev_normal, prev_linear_z,
                        prev_moments, prev_history_len)
    hist_rows = atlas.reshape(lh * w, -1)

    def fetch(y, x):  # y, x inside the image, y a global row
        if row_window is not None:
            y = torch.clamp(y - row0, 0, lh - 1)
        return hist_rows[(y * w + x).reshape(-1)].reshape(lh, w, -1)

    illum = demodulate(color, emission, albedo)
    b = back_project(motion, row0, h, w, cfg)
    x0i, y0i, frac_x, frac_y = b.x0i, b.y0i, b.frac_x, b.frac_y

    # the bilinear quad at the clamped base
    yc = torch.clamp(y0i, 0, h - 1)
    xc = torch.clamp(x0i, 0, w - 1)
    taps = [fetch(torch.clamp_max(yc + dy, h - 1), torch.clamp_max(xc + dx, w - 1))
            for dx, dy in _QUAD]
    weights = [(1 - frac_x) * (1 - frac_y), frac_x * (1 - frac_y),
               (1 - frac_x) * frac_y, frac_x * frac_y]

    sum_w = torch.zeros((lh, w), dtype=torch.float32, device=dev)
    acc_illum = torch.zeros((lh, w, 4), dtype=torch.float32, device=dev)
    acc_mom = torch.zeros((lh, w, 2), dtype=torch.float32, device=dev)
    any_valid = torch.zeros((lh, w), dtype=torch.bool, device=dev)
    for (dx, dy), wt, tap in zip(_QUAD, weights, taps):
        v = _tap_valid(y0i + dy, x0i + dx, h, w, linear_z, fwidth_z,
                       normal, fwidth_normal, tap, cfg)
        any_valid = any_valid | v
        wv = torch.where(v, wt, 0.0)
        sum_w = sum_w + wv
        acc_illum = acc_illum + wv[..., None] * tap[..., _IV]
        acc_mom = acc_mom + wv[..., None] * tap[..., _M]

    bilinear_ok = any_valid & (sum_w >= 0.01)
    if row_window is not None:
        # the rows of every tap below: the bilinear quad and the rescue quads
        lo = torch.minimum(yc, torch.clamp(y0i - 1, 0, h - 2))
        hi = torch.maximum(torch.clamp_max(yc + 1, h - 1),
                           torch.clamp(y0i + 1, 0, h - 2) + 1)
        in_shard = (lo >= row0) & (hi < row0 + lh)
        bilinear_ok = bilinear_ok & in_shard
    safe_w = torch.clamp_min(sum_w, 1e-6)
    prev_i = torch.where(bilinear_ok[..., None], acc_illum / safe_w[..., None], 0.0)
    prev_mo = torch.where(bilinear_ok[..., None], acc_mom / safe_w[..., None], 0.0)

    # 3x3 cross-bilateral rescue (svgf_reproject.frag:111-141)
    n_valid = torch.zeros((lh, w), dtype=torch.float32, device=dev)
    r_illum = torch.zeros((lh, w, 4), dtype=torch.float32, device=dev)
    r_mom = torch.zeros((lh, w, 2), dtype=torch.float32, device=dev)
    if read == "fast":
        # tap (y0 + dy, x0 + dx) taken as the base tap of the pixel
        # (y + dy, x + dx): static shifts of the quad's first tap, exact
        # wherever the integer motion is locally constant
        in_b0 = (x0i >= 0) & (x0i < w) & (y0i >= 0) & (y0i < h)
        for dy, dx in RING:
            tap = shift2d(taps[0], dy, dx)
            v = shift2d(in_b0, dy, dx) & _tap_ok(linear_z, fwidth_z, normal,
                                                 fwidth_normal, tap, cfg)
            vf = v.to(torch.float32)
            n_valid = n_valid + vf
            r_illum = r_illum + vf[..., None] * tap[..., _IV]
            r_mom = r_mom + vf[..., None] * tap[..., _M]
    else:
        # 4 quads tiling the 4x4 neighbourhood, bases clamped to [0, dim - 2]
        for base_dy, base_dx in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
            yb = torch.clamp(y0i + base_dy, 0, h - 2)
            xb = torch.clamp(x0i + base_dx, 0, w - 2)
            for qdx, qdy in _QUAD:
                ty = yb + qdy
                tx = xb + qdx
                tap = fetch(ty, tx)
                in_window = (torch.abs(ty - y0i) <= 1) & (torch.abs(tx - x0i) <= 1)
                if (base_dy, base_dx) != (-1, -1):
                    # only the first quad owns taps with ty <= y0 and tx <= x0
                    in_window = in_window & ~((ty <= y0i) & (tx <= x0i))
                v = in_window & _tap_valid(ty, tx, h, w, linear_z, fwidth_z,
                                           normal, fwidth_normal, tap, cfg)
                vf = v.to(torch.float32)
                n_valid = n_valid + vf
                r_illum = r_illum + vf[..., None] * tap[..., _IV]
                r_mom = r_mom + vf[..., None] * tap[..., _M]
    rescue_ok = (~bilinear_ok) & (n_valid > 0)
    if row_window is not None:
        rescue_ok = rescue_ok & in_shard
    safe_n = torch.clamp_min(n_valid, 1.0)
    prev_i = torch.where(rescue_ok[..., None], r_illum / safe_n[..., None], prev_i)
    prev_mo = torch.where(rescue_ok[..., None], r_mom / safe_n[..., None], prev_mo)

    # history length at the reprojected position: one of the 4 corners
    near_y, near_x = nearest_corner(b, h, w)
    h00, h10, h01, h11 = (t[..., _HL] for t in taps)
    hist_prev = torch.where(near_y, torch.where(near_x, h11, h01),
                            torch.where(near_x, h10, h00))
    return _finish(color, illum, prev_i, prev_mo, bilinear_ok | rescue_ok,
                   hist_prev, sky, prev_moments, prev_history_len, cfg)


def _reproject_tiled(color, emission, albedo, motion, normal, linear_z,
                     fwidth_normal, fwidth_z, prev_illum, prev_variance,
                     prev_normal, prev_linear_z, prev_moments,
                     prev_history_len, cfg,
                     row_window: tuple[int, int] | None = None) -> ReprojectOutput:
    """The tile-windowed read (tpuray/denoise/reproject.py:_reproject_tiled):
    the 9 taps around the clipped base from tile_gather.tiled_taps, on the
    local (halo-extended) rows under a row window, so the tiles start at
    the shard's first row and a tap past the shard does not resolve."""
    lh, w = color.shape[:2]
    row0, h = row_window if row_window is not None else (0, lh)
    b = back_project(motion, row0, h, w, cfg)
    atlas = build_atlas(prev_illum, prev_variance, prev_normal, prev_linear_z,
                        prev_moments, prev_history_len)
    taps, resolved = tiled_taps(atlas, b.y0i - row0, b.x0i, RING)
    near_y, near_x = nearest_corner(b, h, w)
    return tiled_history(color, demodulate(color, emission, albedo), normal, linear_z,
                         fwidth_normal, fwidth_z, b, near_y, near_x, taps, resolved,
                         prev_moments, prev_history_len, h, w, cfg)


def tiled_history(color, illum, normal, linear_z, fwidth_normal, fwidth_z,
                  b: BackProjection, near_y, near_x, taps: dict, resolved: dict,
                  prev_moments, prev_history_len, h: int, w: int,
                  cfg: RenderConfig) -> ReprojectOutput:
    """The tiled read's reprojection from its 9 ring taps, elementwise over
    any leading shape (K4's plain version runs it on a batch of tiles):
    taps[(dy, dx)] (..., 12) history rows, resolved[(dy, dx)] (...) bool;
    h, w: the image the validity tests take. A bilinear or rescue tap counts
    where it resolves and is valid; the history length is the nearest
    corner's tap, resolved or not."""
    sky = linear_z == 1.0
    frac_x, frac_y = b.frac_x, b.frac_y
    weights = {(0, 0): (1 - frac_x) * (1 - frac_y), (0, 1): frac_x * (1 - frac_y),
               (1, 0): (1 - frac_x) * frac_y, (1, 1): frac_x * frac_y}
    def zeros(*c):
        return torch.zeros((*linear_z.shape, *c), dtype=torch.float32, device=sky.device)

    sum_w, acc_illum, acc_mom = zeros(), zeros(4), zeros(2)
    any_valid = torch.zeros_like(sky)
    valid = {}
    for dy, dx in RING:
        valid[(dy, dx)] = resolved[(dy, dx)] & _tap_valid(
            b.y0i + dy, b.x0i + dx, h, w, linear_z, fwidth_z, normal, fwidth_normal,
            taps[(dy, dx)], cfg)
    for e in QUAD_DYDX:
        tap, v = taps[e], valid[e]
        any_valid = any_valid | v
        wv = torch.where(v, weights[e], 0.0)
        sum_w = sum_w + wv
        acc_illum = acc_illum + wv[..., None] * tap[..., _IV]
        acc_mom = acc_mom + wv[..., None] * tap[..., _M]
    bilinear_ok = any_valid & (sum_w >= 0.01)
    safe_w = torch.clamp_min(sum_w, 1e-6)
    prev_i = torch.where(bilinear_ok[..., None], acc_illum / safe_w[..., None], 0.0)
    prev_mo = torch.where(bilinear_ok[..., None], acc_mom / safe_w[..., None], 0.0)

    n_valid, r_illum, r_mom = zeros(), zeros(4), zeros(2)
    for e in RING:
        tap, vf = taps[e], valid[e].to(torch.float32)
        n_valid = n_valid + vf
        r_illum = r_illum + vf[..., None] * tap[..., _IV]
        r_mom = r_mom + vf[..., None] * tap[..., _M]
    rescue_ok = (~bilinear_ok) & (n_valid > 0)
    safe_n = torch.clamp_min(n_valid, 1.0)
    prev_i = torch.where(rescue_ok[..., None], r_illum / safe_n[..., None], prev_i)
    prev_mo = torch.where(rescue_ok[..., None], r_mom / safe_n[..., None], prev_mo)

    hl = {e: taps[e][..., _HL] for e in QUAD_DYDX}
    hist_prev = torch.where(near_y, torch.where(near_x, hl[(1, 1)], hl[(1, 0)]),
                            torch.where(near_x, hl[(0, 1)], hl[(0, 0)]))
    return _finish(color, illum, prev_i, prev_mo, bilinear_ok | rescue_ok,
                   hist_prev, sky, prev_moments, prev_history_len, cfg)


def _finish(color, illum, prev_i, prev_mo, success, hist_prev, sky,
            prev_moments, prev_history_len, cfg) -> ReprojectOutput:
    """EMA + history-length tail (svgf_reproject.frag:143-205)."""
    hist = torch.clamp_max(torch.where(success, hist_prev + 1.0, 1.0),
                           cfg.history_cap)
    alpha = torch.where(success,
                        torch.clamp_min(rdiv(1.0, hist), cfg.alpha_min), 1.0)

    lum = luminance(illum)
    mom_new = torch.stack([lum, lum * lum], dim=-1)
    moments = (1.0 - alpha)[..., None] * prev_mo + alpha[..., None] * mom_new
    variance = torch.clamp_min(
        moments[..., 1] - moments[..., 0] * moments[..., 0], 0.0)
    out_illum = (1.0 - alpha)[..., None] * prev_i[..., :3] \
        + alpha[..., None] * illum

    # sky passthrough (frag:166-171): raw color, keep the prior moments
    out_illum = torch.where(sky[..., None], color, out_illum)
    variance = torch.where(sky, 0.0, variance)
    moments = torch.where(sky[..., None], prev_moments, moments)
    hist = torch.where(sky, prev_history_len, hist)
    return ReprojectOutput(illum=out_illum, variance=variance,
                           moments=moments, history_len=hist)


def _reproject_static(color, emission, albedo, normal, linear_z,
                      fwidth_normal, fwidth_z, prev_illum, prev_variance,
                      prev_normal, prev_linear_z, prev_moments,
                      prev_history_len, cfg,
                      row_window: tuple[int, int] | None = None
                      ) -> ReprojectOutput:
    """Static camera (motion == 0): the bilinear taps collapse to the same
    pixel and the 3x3 rescue reads static shifts. The JAX package's
    static specialisation, semantically the general path at motion 0.
    row_window: the rescue's bounds masks use global rows."""
    h, w = color.shape[:2]
    dev = color.device
    sky = linear_z == 1.0
    illum = demodulate(color, emission, albedo)

    def tap_valid(z_p, n_p):
        depth_ok = (torch.abs(z_p - linear_z) / (fwidth_z + 1e-2)) \
            <= cfg.reproj_depth_threshold
        normal_ok = (norm3(normal - n_p) / (fwidth_normal + 1e-2)) \
            <= cfg.reproj_normal_threshold
        return depth_ok & normal_ok

    prev_iv = torch.cat([prev_illum, prev_variance[..., None]], dim=-1)
    base_valid = tap_valid(prev_linear_z, prev_normal)
    prev_i = torch.where(base_valid[..., None], prev_iv, 0.0)
    prev_mo = torch.where(base_valid[..., None], prev_moments, 0.0)

    n_valid = torch.zeros((h, w), dtype=torch.float32, device=dev)
    r_illum = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
    r_mom = torch.zeros((h, w, 2), dtype=torch.float32, device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            v = tap_valid(shift2d(prev_linear_z, dy, dx),
                          shift2d(prev_normal, dy, dx)) \
                & inside_mask((h, w), dy, dx, dev, row_window)
            vf = v.to(torch.float32)
            n_valid = n_valid + vf
            r_illum = r_illum + vf[..., None] * shift2d(prev_iv, dy, dx)
            r_mom = r_mom + vf[..., None] * shift2d(prev_moments, dy, dx)
    rescue_ok = (~base_valid) & (n_valid > 0)
    safe_n = torch.clamp_min(n_valid, 1.0)
    prev_i = torch.where(rescue_ok[..., None], r_illum / safe_n[..., None], prev_i)
    prev_mo = torch.where(rescue_ok[..., None], r_mom / safe_n[..., None], prev_mo)
    return _finish(color, illum, prev_i, prev_mo, base_valid | rescue_ok,
                   prev_history_len, sky, prev_moments, prev_history_len, cfg)
