# The benchmark's reference: a frozen copy of tpuray_torch/integrator/gbuffer.py (its
# imports pointed here). The program may change; this copy does not.
"""G-buffer from the primary hit (counterpart of tpuray/integrator/gbuffer.py).

linear_z replicates gl_FragCoord.z / gl_FragCoord.w with 1.0 for sky;
velocity = current uv - previous uv of the hit's world position; fwidth
terms use 2x2-quad derivatives like hardware `fwidth`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class GBuffer(NamedTuple):
    normal: Tensor         # (H, W, 3)
    linear_z: Tensor       # (H, W) 1.0 = sky
    velocity: Tensor       # (H, W, 2) uv units
    fwidth_normal: Tensor  # (H, W)
    fwidth_z: Tensor       # (H, W)
    world_pos: Tensor      # (H, W, 3)


def quad_ddx(img: Tensor) -> Tensor:
    """ddx within aligned 2x2 quads: both pixels of a pair get
    v[x|1] - v[x&~1]."""
    w = img.shape[1]
    d = img[:, 1:w:2] - img[:, 0:w:2]
    return torch.repeat_interleave(d, 2, dim=1)[:, :w]


def quad_ddy(img: Tensor) -> Tensor:
    h = img.shape[0]
    d = img[1:h:2] - img[0:h:2]
    return torch.repeat_interleave(d, 2, dim=0)[:h]


def _project_uv(view_proj: Tensor, p: Tensor) -> tuple[Tensor, Tensor]:
    """world point -> (uv in [0,1]^2, clip w). The 4x4 product is written
    out elementwise, so it rounds the same on every device."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    clip = [view_proj[i, 0] * x + view_proj[i, 1] * y + view_proj[i, 2] * z
            + view_proj[i, 3] for i in (0, 1, 3)]
    w = clip[2]
    ndc = torch.stack(clip[:2], dim=-1) / torch.where(
        torch.abs(w) < 1e-12, 1e-12, w)[..., None]
    return ndc * 0.5 + 0.5, w


def build_gbuffer(point: Tensor, normal: Tensor, valid: Tensor,
                  view_proj: Tensor, prev_view_proj: Tensor,
                  near: float = 0.01, far: float = 1000.0) -> GBuffer:
    """point/normal/valid: (H, W, 3)/(H, W, 3)/(H, W) from the primary hit."""
    uv_now, w_now = _project_uv(view_proj, point)
    uv_prev, _ = _project_uv(prev_view_proj, point)
    velocity = torch.where(valid[..., None], uv_now - uv_prev, 0.0)

    d = torch.clamp_min(w_now, near)  # clip_w == view-space distance
    ndc_z = ((far + near) - 2.0 * far * near / d) / (far - near)
    window_z = 0.5 * (ndc_z + 1.0)
    linear_z = torch.where(valid, window_z * d, 1.0)

    nrm = torch.where(valid[..., None], normal, 0.0)
    fw_n = torch.sqrt(torch.sum(
        (torch.abs(quad_ddx(nrm)) + torch.abs(quad_ddy(nrm))) ** 2, dim=-1))
    fw_z = torch.maximum(torch.abs(quad_ddx(linear_z)),
                         torch.abs(quad_ddy(linear_z)))
    return GBuffer(normal=nrm, linear_z=linear_z, velocity=velocity,
                   fwidth_normal=fw_n, fwidth_z=fw_z,
                   world_pos=torch.where(valid[..., None], point, 0.0))
