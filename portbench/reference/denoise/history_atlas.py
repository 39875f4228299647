# The benchmark's reference: a frozen copy of tpuray_torch/denoise/history_atlas.py (its
# imports pointed here). The program may change; this copy does not.
"""The previous frame's buffers packed into one history atlas (counterpart
of tpuray/denoise/history_atlas.py).

Reprojection reads illumination, variance, normal, depth, moments and
history length at the same reprojected texel, so they travel as one
(H, W, 12) atlas in tpuray's channel order:

    [illum(3) | variance(1) | normal(3) | linear_z(1) | moments(2) | hist(1) | pad]

tpuray also quad-packs the atlas to (H, W, 48), so that the 4 bilinear taps
are one TPU gather; that packing is a TPU gather trick and is left out: a
GPU reads a tap's row directly.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

# the fields' channels (tpuray's split): illum and variance together (the
# taps' weighted sums), normal, linear_z, moments, history length
IV, NORMAL, Z, MOMENTS, HIST = slice(0, 4), slice(4, 7), 7, slice(8, 10), 10


def build_atlas(illum: Tensor, variance: Tensor, normal: Tensor, linear_z: Tensor,
                moments: Tensor, history_len: Tensor) -> Tensor:
    """-> the (H, W, 12) atlas."""
    pad = torch.zeros_like(linear_z)[..., None]
    return torch.cat([illum, variance[..., None], normal, linear_z[..., None],
                      moments, history_len[..., None], pad], dim=-1)

