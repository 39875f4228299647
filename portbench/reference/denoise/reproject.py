# The benchmark's reference: a frozen copy of tpuray_torch/denoise/reproject.py (its
# imports pointed here). The program may change; this copy does not.
"""SVGF temporal reprojection (counterpart of tpuray/denoise/reproject.py,
shaders/svgf_reproject.frag).

Demodulate the 1spp color, back-project by the motion vectors, validate the
4 bilinear history taps against depth and normal consistency, take a 3x3
cross-bilateral rescue where all fail, then an EMA of illumination and
luminance moments with history-length control.

The moving camera's history read is the exact one (reproject_gather
"auto" or "exact"): per-pixel reads on the whole image, the plain version
of K4's exact instance (kernels/reproject.py). The benchmark's cells run
no other read, no row window and no still camera, so this copy has none
(config.RenderConfig refuses the other reads).

The clamps of the JAX package's quad-packed history fetch are repeated
here, not fixed:
- the 4 bilinear taps come from one 2x2 quad at the clamped base
  (clamp(y0), clamp(x0)), whose right/down neighbours clamp at the last
  row and column: where x0 = -1, taps 0 and 1 read texels 0 and 1. Their
  validity uses the unclamped x0 + dx, y0 + dy;
- the rescue's taps come from 4 quads at bases clamped to [0, dim - 2],
  with the in-window and first-quad-owns masks, so at the border an edge
  tap can be counted twice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.denoise.common import luminance, norm3, rdiv
from portbench.reference.denoise.history_atlas import HIST as _HL
from portbench.reference.denoise.history_atlas import IV as _IV
from portbench.reference.denoise.history_atlas import MOMENTS as _M
from portbench.reference.denoise.history_atlas import NORMAL as _N
from portbench.reference.denoise.history_atlas import Z as _Z
from portbench.reference.denoise.history_atlas import build_atlas
from portbench.reference.config import RenderConfig

Tensor = torch.Tensor

_QUAD = ((0, 0), (1, 0), (0, 1), (1, 1))  # (dx, dy) of the bilinear taps


class ReprojectOutput(NamedTuple):
    illum: Tensor        # (H, W, 3) temporally accumulated illumination
    variance: Tensor     # (H, W)
    moments: Tensor      # (H, W, 2)
    history_len: Tensor  # (H, W)


def demodulate(color: Tensor, emission: Tensor, albedo: Tensor) -> Tensor:
    """(color - emission) / max(albedo, 1e-3), NaN set to 0
    (svgf_reproject.frag:26-29, 174)."""
    illum = (color - emission) / torch.clamp_min(albedo, 1e-3)
    return torch.where(torch.isnan(illum), 0.0, illum)


class BackProjection(NamedTuple):
    fx: Tensor      # the float history position, pixel centres at i + 0.5
    fy: Tensor
    x0i: Tensor     # its floor (int64), unclipped
    y0i: Tensor
    frac_x: Tensor  # the bilinear fractions
    frac_y: Tensor


def back_project(motion: Tensor) -> BackProjection:
    """uv_prev = uv - motion of each pixel of the (H, W) motion. The
    divisors are tensors: on the card PyTorch computes `t / scalar` as
    t * (1 / scalar), which can move floor(fx) off K4's IEEE division."""
    h, w = motion.shape[:2]
    dev = motion.device
    yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    w_t = torch.full_like(motion[..., 0], w)
    h_t = torch.full_like(motion[..., 0], h)
    uv_x = (xx.to(torch.float32) + 0.5) / w_t - motion[..., 0]
    uv_y = (yy.to(torch.float32) + 0.5) / h_t - motion[..., 1]
    fx = uv_x * w - 0.5
    fy = uv_y * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    return BackProjection(fx, fy, x0.to(torch.int64), y0.to(torch.int64), fx - x0, fy - y0)


def nearest_corner(b: BackProjection, h: int, w: int) -> tuple[Tensor, Tensor]:
    """(near_y, near_x): round(f) is the bilinear corner (near_y, near_x)
    of the clamped base (a clamped-index compare, as the clamped fetch)."""
    near_x = torch.clamp(torch.round(b.fx).to(torch.int64), 0, w - 1) \
        > torch.clamp(b.x0i, 0, w - 1)
    near_y = torch.clamp(torch.round(b.fy).to(torch.int64), 0, h - 1) \
        > torch.clamp(b.y0i, 0, h - 1)
    return near_y, near_x


def _tap_valid(yi, xi, h, w, z_cur, fw_z, n_cur, fw_n, tap, cfg):
    """isReprjValid (svgf_reproject.frag:31-43) against a history row."""
    in_b = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    depth_ok = (torch.abs(tap[..., _Z] - z_cur) / (fw_z + 1e-2)) \
        <= cfg.reproj_depth_threshold
    normal_ok = (norm3(n_cur - tap[..., _N]) / (fw_n + 1e-2)) \
        <= cfg.reproj_normal_threshold
    return in_b & depth_ok & normal_ok


def reproject(color: Tensor, emission: Tensor, albedo: Tensor,
              motion: Tensor, normal: Tensor, linear_z: Tensor,
              fwidth_normal: Tensor, fwidth_z: Tensor,
              prev_illum: Tensor, prev_variance: Tensor,
              prev_normal: Tensor, prev_linear_z: Tensor,
              prev_moments: Tensor, prev_history_len: Tensor,
              cfg: RenderConfig) -> ReprojectOutput:
    h, w = color.shape[:2]
    dev = color.device
    sky = linear_z == 1.0
    atlas = build_atlas(prev_illum, prev_variance, prev_normal, prev_linear_z,
                        prev_moments, prev_history_len)
    hist_rows = atlas.reshape(h * w, -1)

    def fetch(y, x):  # y, x inside the image
        return hist_rows[(y * w + x).reshape(-1)].reshape(h, w, -1)

    illum = demodulate(color, emission, albedo)
    b = back_project(motion)
    x0i, y0i, frac_x, frac_y = b.x0i, b.y0i, b.frac_x, b.frac_y

    # the bilinear quad at the clamped base
    yc = torch.clamp(y0i, 0, h - 1)
    xc = torch.clamp(x0i, 0, w - 1)
    taps = [fetch(torch.clamp_max(yc + dy, h - 1), torch.clamp_max(xc + dx, w - 1))
            for dx, dy in _QUAD]
    weights = [(1 - frac_x) * (1 - frac_y), frac_x * (1 - frac_y),
               (1 - frac_x) * frac_y, frac_x * frac_y]

    sum_w = torch.zeros((h, w), dtype=torch.float32, device=dev)
    acc_illum = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
    acc_mom = torch.zeros((h, w, 2), dtype=torch.float32, device=dev)
    any_valid = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for (dx, dy), wt, tap in zip(_QUAD, weights, taps):
        v = _tap_valid(y0i + dy, x0i + dx, h, w, linear_z, fwidth_z,
                       normal, fwidth_normal, tap, cfg)
        any_valid = any_valid | v
        wv = torch.where(v, wt, 0.0)
        sum_w = sum_w + wv
        acc_illum = acc_illum + wv[..., None] * tap[..., _IV]
        acc_mom = acc_mom + wv[..., None] * tap[..., _M]

    bilinear_ok = any_valid & (sum_w >= 0.01)
    safe_w = torch.clamp_min(sum_w, 1e-6)
    prev_i = torch.where(bilinear_ok[..., None], acc_illum / safe_w[..., None], 0.0)
    prev_mo = torch.where(bilinear_ok[..., None], acc_mom / safe_w[..., None], 0.0)

    # 3x3 cross-bilateral rescue (svgf_reproject.frag:111-141): 4 quads
    # tiling the 4x4 neighbourhood, bases clamped to [0, dim - 2]
    n_valid = torch.zeros((h, w), dtype=torch.float32, device=dev)
    r_illum = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
    r_mom = torch.zeros((h, w, 2), dtype=torch.float32, device=dev)
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
