"""SVGF spatial variance fallback (counterpart of tpuray/denoise/variance.py,
shaders/svgf_variance.frag).

Pixels with fewer than 4 frames of history estimate illumination and
moments with a 7x7 cross-bilateral filter (edge-stopping in depth, normal
and luminance) and boost the variance by 4/h; others pass through.
This is the plain version of K4's second pass (kernels/reproject.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpuray_torch.denoise.common import (
    dot3, inside_mask, luminance, pow_weight, rdiv, shift2d)
from tpuray_torch.scene.config import RenderConfig

Tensor = torch.Tensor


def edge_stopping_weight(z_c, z_p, phi_depth, n_c, n_p, phi_normal,
                         l_c, l_p, phi_illum):
    """computeWeight (svgf_variance.frag:23-35 == svgf_Atrous.frag:43-55)."""
    w_normal = pow_weight(dot3(n_c, n_p), phi_normal)
    w_z = torch.where(phi_depth == 0.0, 0.0, torch.abs(z_c - z_p)
                      / torch.where(phi_depth == 0.0, 1.0, phi_depth))
    # phi_illum can be 0 (a slightly negative blurred variance clamps to 0);
    # 0/0 on a flat dark region would poison the filter with NaN.
    if not isinstance(phi_illum, torch.Tensor):
        # a tensor divisor, as above: IEEE division on every device
        phi_illum = torch.full_like(l_c, float(phi_illum))
    w_l = torch.abs(l_c - l_p) / torch.clamp_min(phi_illum, 1e-10)
    return torch.exp(-torch.clamp_min(w_l, 0.0)
                     - torch.clamp_min(w_z, 0.0)) * w_normal


class VarianceOutput(NamedTuple):
    illum: Tensor     # (H, W, 3)
    variance: Tensor  # (H, W)


def estimate_variance(illum: Tensor, variance: Tensor, moments: Tensor,
                      history_len: Tensor, normal: Tensor, linear_z: Tensor,
                      fwidth_z: Tensor, cfg: RenderConfig,
                      row_window: tuple[int, int] | None = None) -> VarianceOutput:
    """row_window=(row0, global_h): the inputs are a halo-extended row
    shard; the bounds masks use global rows (dist/frame.py)."""
    shape = illum.shape[:2]
    dev = illum.device
    sky = linear_z == 1.0
    needs = (history_len < 4.0) & ~sky

    l_center = luminance(illum)
    phi_depth = torch.clamp_min(fwidth_z, 1e-8) * 3.0

    sum_w = torch.zeros(shape, dtype=torch.float32, device=dev)
    sum_illum = torch.zeros_like(illum)
    sum_mom = torch.zeros_like(moments)
    radius = 3
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            inside = inside_mask(shape, dy, dx, dev, row_window)
            il_p = shift2d(illum, dy, dx)
            mo_p = shift2d(moments, dy, dx)
            z_p = shift2d(linear_z, dy, dx)
            n_p = shift2d(normal, dy, dx)
            dist = float((dx * dx + dy * dy) ** 0.5)
            wgt = edge_stopping_weight(
                linear_z, z_p, phi_depth * dist, normal, n_p, cfg.sigma_n,
                l_center, luminance(il_p), cfg.sigma_l)
            wgt = torch.where(inside, wgt, 0.0)
            sum_w = sum_w + wgt
            sum_illum = sum_illum + wgt[..., None] * il_p
            sum_mom = sum_mom + wgt[..., None] * mo_p

    sum_w = torch.clamp_min(sum_w, 1e-6)
    est_illum = sum_illum / sum_w[..., None]
    est_mom = sum_mom / sum_w[..., None]
    est_var = (est_mom[..., 1] - est_mom[..., 0] * est_mom[..., 0]) * rdiv(
        4.0, torch.clamp_min(history_len, 1e-3))

    out_illum = torch.where(needs[..., None], est_illum, illum)
    out_var = torch.where(needs, est_var, variance)
    return VarianceOutput(illum=out_illum, variance=out_var)
