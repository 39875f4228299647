# The benchmark's reference: a frozen copy of tpuray_torch/denoise/taa.py (its
# imports pointed here). The program may change; this copy does not.
"""Temporal anti-aliasing (counterpart of tpuray/denoise/taa.py,
shaders/taa.frag).

3x3 closest-depth velocity dilation, YCoCg-R colour space, luminance
tonemap for clipping stability, mu +/- gamma*sigma variance clipping of the
history toward the current 3x3 neighbourhood, velocity-scaled blend.

The moving-camera history fetch is the JAX package's off-TPU one, a
bilinear read of a clamped 2x2 quad (gather_tables.bilinear_fetch_packed):
at u = 0 it blends texels 0 and 1 half and half, unlike GL's clamp. The
benchmark's cells run no tiled fetch, no row window and no still camera,
so this copy has none.
"""
from __future__ import annotations

import torch

from portbench.reference.denoise.common import shift2d

Tensor = torch.Tensor


def rgb_to_ycocgr(c: Tensor) -> Tensor:
    co = c[..., 0] - c[..., 2]
    tmp = c[..., 2] + co / 2.0
    cg = c[..., 1] - tmp
    y = tmp + cg / 2.0
    return torch.stack([y, co, cg], dim=-1)


def ycocgr_to_rgb(c: Tensor) -> Tensor:
    tmp = c[..., 0] - c[..., 2] / 2.0
    g = c[..., 2] + tmp
    b = tmp - c[..., 1] / 2.0
    r = b + c[..., 1]
    return torch.stack([r, g, b], dim=-1)


def _taa_luminance(c: Tensor) -> Tensor:
    return 0.25 * c[..., 0] + 0.5 * c[..., 1] + 0.25 * c[..., 2]


def taa_tonemap(c: Tensor) -> Tensor:
    return c / (1.0 + _taa_luminance(c))[..., None]


def taa_untonemap(c: Tensor) -> Tensor:
    return c / torch.clamp_min(1.0 - _taa_luminance(c), 1e-6)[..., None]


def closest_velocity(velocity: Tensor, linear_z: Tensor) -> Tensor:
    """Velocity of the closest-depth pixel in the 3x3 neighbourhood
    (taa.frag:15-39); the first strict minimum in dy-major order wins."""
    best_z = torch.full_like(linear_z, float("inf"))
    best_vel = velocity
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            z = shift2d(linear_z, dy, dx)
            better = z < best_z
            best_z = torch.where(better, z, best_z)
            best_vel = torch.where(better[..., None],
                                   shift2d(velocity, dy, dx), best_vel)
    return best_vel


def clip_aabb(mu: Tensor, sigma: Tensor, prev_ycc: Tensor,
              gamma: float = 1.0) -> Tensor:
    """Variance clip of the history toward the neighbourhood box centre
    (taa.frag:80-121)."""
    aabb_min = mu - gamma * sigma
    aabb_max = mu + gamma * sigma
    p_clip = 0.5 * (aabb_max + aabb_min)
    e_clip = 0.5 * (aabb_max - aabb_min)
    v_clip = prev_ycc - p_clip
    v_unit = v_clip / torch.where(torch.abs(e_clip) < 1e-12, 1e-12, e_clip)
    ma = torch.amax(torch.abs(v_unit), dim=-1, keepdim=True)
    clipped = p_clip + v_clip / torch.clamp_min(ma, 1e-12)
    return torch.where(ma > 1.0, clipped, prev_ycc)


def bilinear_fetch_clamped(img: Tensor, u: Tensor, v: Tensor) -> Tensor:
    """Bilinear read of (H, W, C) at uv in [0, 1]: the base texel clamps to
    the image and its right/down neighbours clamp at the last column/row,
    the weights are those of the unclamped position."""
    h, w = img.shape[0], img.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    x1i = torch.clamp_max(x0i + 1, w - 1)
    y1i = torch.clamp_max(y0i + 1, h - 1)
    flat = img.reshape(h * w, -1)

    def at(yi, xi):
        return flat[(yi * w + xi).reshape(-1)].reshape(*yi.shape, -1)

    c00, c10, c01, c11 = at(y0i, x0i), at(y0i, x1i), at(y1i, x0i), at(y1i, x1i)
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) \
        + (c01 * (1 - fx) + c11 * fx) * fy


def taa(cur_color: Tensor, prev_color: Tensor, velocity: Tensor,
        linear_z: Tensor, frame: int) -> Tensor:
    """The moving camera's TAA on the whole image."""
    h, w = linear_z.shape
    dev = linear_z.device
    sky = linear_z == 1.0
    vel = closest_velocity(velocity, linear_z)
    yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    u = torch.clamp((xx + 0.5) / w - vel[..., 0], 0.0, 1.0)
    v = torch.clamp((yy + 0.5) / h - vel[..., 1], 0.0, 1.0)
    prev = bilinear_fetch_clamped(prev_color, u, v)

    now_ycc = rgb_to_ycocgr(taa_tonemap(cur_color))
    prev_ycc = rgb_to_ycocgr(taa_tonemap(prev))

    m1 = torch.zeros_like(now_ycc)
    m2 = torch.zeros_like(now_ycc)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            c = rgb_to_ycocgr(taa_tonemap(shift2d(cur_color, dy, dx)))
            m1 = m1 + c
            m2 = m2 + c * c
    mu = m1 / 9.0
    sigma = torch.sqrt(torch.abs(m2 / 9.0 - mu * mu))

    prev_ycc = clip_aabb(mu, sigma, prev_ycc)
    now_rgb = taa_untonemap(ycocgr_to_rgb(now_ycc))
    prev_rgb = taa_untonemap(ycocgr_to_rgb(prev_ycc))

    speed = torch.sqrt(vel[..., 0] * vel[..., 0] + vel[..., 1] * vel[..., 1])
    blend = torch.clamp(0.05 + speed * 100.0, 0.0, 1.0)
    out = blend[..., None] * now_rgb + (1.0 - blend)[..., None] * prev_rgb

    passthrough = sky | (frame == 0)
    return torch.where(passthrough[..., None], cur_color, out)
