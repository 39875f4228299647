"""SVGF temporal reprojection (counterpart of tpuray/denoise/reproject.py,
shaders/svgf_reproject.frag).

Demodulate the 1spp color, back-project by the motion vectors, validate the
4 bilinear history taps against depth and normal consistency, take a 3x3
cross-bilateral rescue where all fail, then an EMA of illumination and
luminance moments with history-length control.

This is the JAX package's "exact" path (per-pixel history reads), the
plain version of K4's first pass (kernels/reproject.py), and the static-
camera specialisation. The TPU's "tiled" and "fast" history reads are
answers to slow TPU gathers and are not ported: asking for them raises.

The clamps of the JAX package's quad-packed history fetch are repeated
here, not fixed:
- the 4 bilinear taps come from one 2x2 quad at the clamped base
  (clamp(y0), clamp(x0)), whose right/down neighbours clamp at the last
  row and column: where x0 = -1, taps 0 and 1 read texels 0 and 1. Their
  validity uses the unclamped x0 + dx, y0 + dy;
- the rescue taps come from 4 quads at bases clamped to [0, dim - 2], with
  the in-window and first-quad-owns masks, so at the border an edge tap
  can be counted twice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpuray_torch.denoise.common import (
    inside_mask, luminance, norm3, rdiv, shift2d)
from tpuray_torch.scene.config import RenderConfig

Tensor = torch.Tensor

# channels of the stacked history: illum 0:3, variance 3, normal 4:7,
# linear_z 7, moments 8:10, history_len 10
_IV, _N, _Z, _M, _HL = slice(0, 4), slice(4, 7), 7, slice(8, 10), 10
_QUAD = ((0, 0), (1, 0), (0, 1), (1, 1))  # (dx, dy) of the bilinear taps


class ReprojectOutput(NamedTuple):
    illum: Tensor        # (H, W, 3) temporally accumulated illumination
    variance: Tensor     # (H, W)
    moments: Tensor      # (H, W, 2)
    history_len: Tensor  # (H, W)


def gather_mode(cfg: RenderConfig) -> str:
    """The moving-camera history read: "auto" and "exact" are the exact
    path on every device; the TPU's "tiled" and "fast" reads raise."""
    if cfg.fast_reproject:
        raise NotImplementedError(
            "fast_reproject=True is a TPU-only history read (static shifts of "
            "one quad gather) and is not ported; the port reprojects exactly")
    if cfg.reproject_gather in ("auto", "exact"):
        return "exact"
    if cfg.reproject_gather == "tiled":
        raise NotImplementedError(
            "reproject_gather='tiled' is a TPU-only history read (the "
            "tile-windowed fetch) and is not ported; use 'auto' or 'exact'")
    raise ValueError(f"unknown reproject_gather {cfg.reproject_gather!r}")


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


def _history_rows(prev_illum, prev_variance, prev_normal, prev_linear_z,
                  prev_moments, prev_history_len) -> Tensor:
    """The previous frame's buffers as one (H*W, 11) table of rows."""
    st = torch.cat([prev_illum, prev_variance[..., None], prev_normal,
                    prev_linear_z[..., None], prev_moments,
                    prev_history_len[..., None]], dim=-1)
    return st.reshape(-1, st.shape[-1])


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
              cfg: RenderConfig, static_camera: bool = False
              ) -> ReprojectOutput:
    if static_camera:
        return _reproject_static(
            color, emission, albedo, normal, linear_z, fwidth_normal,
            fwidth_z, prev_illum, prev_variance, prev_normal, prev_linear_z,
            prev_moments, prev_history_len, cfg)
    gather_mode(cfg)
    h, w = color.shape[:2]
    dev = color.device
    yy, xx = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    sky = linear_z == 1.0
    hist_rows = _history_rows(prev_illum, prev_variance, prev_normal,
                              prev_linear_z, prev_moments, prev_history_len)

    def fetch(y, x):  # y, x already inside the image
        return hist_rows[(y * w + x).reshape(-1)].reshape(h, w, -1)

    illum = demodulate(color, emission, albedo)

    # back-projected float pixel position: uv_prev = uv - motion, pixel
    # centres at i + 0.5. The divisors are tensors: on the card PyTorch
    # computes `t / scalar` as t * (1 / scalar), which can move floor(fx)
    # off K4's IEEE division.
    w_t = torch.full_like(linear_z, w)
    h_t = torch.full_like(linear_z, h)
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
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

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

    # 3x3 cross-bilateral rescue (svgf_reproject.frag:111-141) from 4 quads
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

    # history length at the reprojected position: round(f) is one of the 4
    # bilinear corners (clamped-index compare, as the clamped fetch)
    near_x = torch.clamp(torch.round(fx).to(torch.int64), 0, w - 1) > xc
    near_y = torch.clamp(torch.round(fy).to(torch.int64), 0, h - 1) > yc
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


def _reproject_static(color, emission, albedo, normal, linear_z,
                      fwidth_normal, fwidth_z, prev_illum, prev_variance,
                      prev_normal, prev_linear_z, prev_moments,
                      prev_history_len, cfg) -> ReprojectOutput:
    """Static camera (motion == 0): the bilinear taps collapse to the same
    pixel and the 3x3 rescue reads static shifts. The JAX package's
    static specialisation, semantically the general path at motion 0."""
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
                & inside_mask((h, w), dy, dx, dev)
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
