"""SVGF edge-aware a-trous wavelet filter (counterpart of
tpuray/denoise/atrous.py, shaders/svgf_Atrous.frag).

One iteration is a dilated 5x5 B3-spline stencil (weights [1, 2/3, 1/6])
with edge-stopping in depth, normal and luminance; the variance channel is
filtered with squared weights and divided by sum_w^2. phi_illum is scaled
by the sqrt of a 3x3-blurred variance (clamp-to-edge, no mask; identity
under reference_quirks). This is the plain version of K5
(kernels/atrous.py).
"""
from __future__ import annotations

import torch

from tpuray_torch.denoise.common import inside_mask, luminance, shift2d
from tpuray_torch.denoise.variance import edge_stopping_weight
from tpuray_torch.scene.config import RenderConfig

Tensor = torch.Tensor

KERNEL_1D = (1.0, 2.0 / 3.0, 1.0 / 6.0)
# 3x3 variance pre-blur weights by (|dx|, |dy|) (svgf_Atrous.frag:24-27)
VAR_KERNEL = {(0, 0): 1 / 4, (1, 0): 1 / 8, (0, 1): 1 / 8, (1, 1): 1 / 16}


def blur_variance_3x3(variance: Tensor, reference_quirks: bool) -> Tensor:
    if reference_quirks:
        return variance  # the centre texel read 9 times; weights sum to 1
    out = torch.zeros_like(variance)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = out + VAR_KERNEL[(abs(dx), abs(dy))] * shift2d(variance, dy, dx)
    return out


def atrous_iteration(illum: Tensor, variance: Tensor, normal: Tensor,
                     linear_z: Tensor, fwidth_z: Tensor, step: int,
                     cfg: RenderConfig, row_window: tuple[int, int] | None = None
                     ) -> tuple[Tensor, Tensor]:
    """One wavelet iteration at dilation `step` (1 << i) ->
    (filtered illum (H, W, 3), filtered variance (H, W)).

    row_window=(row0, global_h): the inputs are a halo-extended row shard;
    the bounds masks use global rows (dist/frame.py)."""
    shape = illum.shape[:2]
    dev = illum.device
    sky = linear_z == 1.0

    l_center = luminance(illum)
    var_blur = blur_variance_3x3(variance, cfg.reference_quirks)
    phi_l = cfg.sigma_l * torch.sqrt(torch.clamp_min(1e-10 + var_blur, 1e-10))
    phi_depth = torch.clamp_min(fwidth_z, 1e-8) * step

    sum_w = torch.ones(shape, dtype=torch.float32, device=dev)  # centre: 1
    sum_illum = illum
    sum_var = variance                                 # centre, weight^2 = 1
    for yy in (-2, -1, 0, 1, 2):
        for xx in (-2, -1, 0, 1, 2):
            if xx == 0 and yy == 0:
                continue
            dy, dx = yy * step, xx * step
            il_p = shift2d(illum, dy, dx)
            var_p = shift2d(variance, dy, dx)
            kernel = KERNEL_1D[abs(xx)] * KERNEL_1D[abs(yy)]
            dist = float((xx * xx + yy * yy) ** 0.5)
            wgt = edge_stopping_weight(
                linear_z, shift2d(linear_z, dy, dx), phi_depth * dist,
                normal, shift2d(normal, dy, dx), cfg.sigma_n,
                l_center, luminance(il_p), phi_l)
            wgt = torch.where(inside_mask(shape, dy, dx, dev, row_window), wgt * kernel, 0.0)
            sum_w = sum_w + wgt
            sum_illum = sum_illum + wgt[..., None] * il_p
            sum_var = sum_var + wgt * wgt * var_p

    out_illum = sum_illum / sum_w[..., None]
    out_var = sum_var / (sum_w * sum_w)
    out_illum = torch.where(sky[..., None], illum, out_illum)
    out_var = torch.where(sky, variance, out_var)
    return out_illum, out_var
