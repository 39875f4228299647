"""Temporal anti-aliasing (counterpart of tpuray/denoise/taa.py,
shaders/taa.frag).

3x3 closest-depth velocity dilation, YCoCg-R colour space, luminance
tonemap for clipping stability, mu +/- gamma*sigma variance clipping of the
history toward the current 3x3 neighbourhood, velocity-scaled blend.

The moving-camera history fetch is, by default, the JAX package's off-TPU
one, a bilinear read of a clamped 2x2 quad (gather_tables.
bilinear_fetch_packed): at u = 0 it blends texels 0 and 1 half and half,
unlike GL's clamp. tiled_fetch=True reads the 4 bilinear taps through the
tile-windowed read (denoise/tile_gather.py) as tpuray does under
reproject_gather="tiled" and in its sharded frame: a tap that does not
resolve drops out with its weight, and a pixel with none rejects its
history.

This is the plain version. Under pallas_denoise on the card,
denoise/svgf.py:svgf_pipeline runs TAA as one CUDA kernel
(kernels/taa.py, csrc/taa.cu), whose output equals taa's bit for bit;
under the tile-windowed read it runs this function.
"""
from __future__ import annotations

import torch

from tpuray_torch.denoise.common import shift2d
from tpuray_torch.denoise.tile_gather import QUAD, tiled_taps
from tpuray_torch.utils.metrics import span

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


def bilinear_fetch_clamped(img: Tensor, u: Tensor, v: Tensor,
                           row_window: tuple[int, int] | None = None
                           ) -> tuple[Tensor, Tensor | None]:
    """Bilinear read of (H, W, C) at uv in [0, 1]: the base texel clamps to
    the image and its right/down neighbours clamp at the last column/row,
    the weights are those of the unclamped position -> (value, in_shard).

    row_window=(row0, global_h): img is a halo-extended row shard of a
    taller image and v is global; the rows are taken in the global image
    and read at global row - row0. in_shard is False where a tap row lies
    outside the shard (None without a row window)."""
    lh, w = img.shape[0], img.shape[1]
    row0, h = row_window if row_window is not None else (0, lh)
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
    in_shard = None
    if row_window is not None:
        y0i, y1i = y0i - row0, y1i - row0
        in_shard = (y0i >= 0) & (y1i < lh)
        y0i, y1i = torch.clamp(y0i, 0, lh - 1), torch.clamp(y1i, 0, lh - 1)
    flat = img.reshape(lh * w, -1)

    def at(yi, xi):
        return flat[(yi * w + xi).reshape(-1)].reshape(*yi.shape, -1)

    c00, c10, c01, c11 = at(y0i, x0i), at(y0i, x1i), at(y1i, x0i), at(y1i, x1i)
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) \
        + (c01 * (1 - fx) + c11 * fx) * fy, in_shard


def history_fetch_tiled(prev_color: Tensor, vel: Tensor,
                        row_window: tuple[int, int] | None = None
                        ) -> tuple[Tensor, Tensor]:
    """The bilinear history fetch through the tile-windowed read
    (tpuray/denoise/taa.py:_history_fetch_tiled) -> (value, hist_ok): the
    resolved taps' weights renormalised, hist_ok where any resolved. Under
    a row window the tiles start at the shard's first row and a tap past
    the shard does not resolve."""
    h, w = prev_color.shape[:2]
    row0, gh = row_window if row_window is not None else (0, h)
    dev = prev_color.device
    yy, xx = torch.meshgrid(torch.arange(h, device=dev) + row0,
                            torch.arange(w, device=dev), indexing="ij")
    x = xx.to(torch.float32) + 0.5 - vel[..., 0] * w - 0.5
    y = yy.to(torch.float32) + 0.5 - vel[..., 1] * gh - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    taps, res = tiled_taps(prev_color, y0.to(torch.int64) - row0, x0.to(torch.int64), QUAD)
    weights = {(0, 0): (1 - fx) * (1 - fy), (0, 1): fx * (1 - fy),
               (1, 0): (1 - fx) * fy, (1, 1): fx * fy}
    acc = torch.zeros_like(prev_color)
    wsum = torch.zeros((h, w, 1), dtype=torch.float32, device=dev)
    for e, wt in weights.items():
        wv = torch.where(res[e][..., None], wt, 0.0)
        acc = acc + wv * taps[e]
        wsum = wsum + wv
    return acc / torch.clamp_min(wsum, 1e-6), wsum[..., 0] > 1e-6


def taa(cur_color: Tensor, prev_color: Tensor, velocity: Tensor,
        linear_z: Tensor, frame: int, static_camera: bool = False,
        tiled_fetch: bool = False,
        row_window: tuple[int, int] | None = None) -> Tensor:
    """row_window=(row0, global_h): the inputs are a halo-extended row shard
    (dist/frame.py). The moving camera's history uv is clamped to the
    global image and read from the shard; a pixel whose history taps lie
    outside the shard rejects its history (blend 1), as tpuray's hist_ok
    does. tiled_fetch: the tile-windowed fetch (history_fetch_tiled)."""
    with span("tpuray.taa"):
        h, w = linear_z.shape
        dev = linear_z.device
        sky = linear_z == 1.0
        hist_ok = None

        if static_camera:
            # motion == 0: the history is the same pixel
            vel = torch.zeros((h, w, 2), dtype=torch.float32, device=dev)
            prev = prev_color
        elif tiled_fetch:
            vel = closest_velocity(velocity, linear_z)
            prev, hist_ok = history_fetch_tiled(prev_color, vel, row_window)
        else:
            vel = closest_velocity(velocity, linear_z)
            row0, gh = row_window if row_window is not None else (0, h)
            yy, xx = torch.meshgrid(torch.arange(h, device=dev) + row0,
                                    torch.arange(w, device=dev), indexing="ij")
            u = torch.clamp((xx + 0.5) / w - vel[..., 0], 0.0, 1.0)
            v = torch.clamp((yy + 0.5) / gh - vel[..., 1], 0.0, 1.0)
            prev, hist_ok = bilinear_fetch_clamped(prev_color, u, v, row_window)

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
        if hist_ok is not None:
            blend = torch.where(hist_ok, blend, 1.0)  # no history: the current color
        out = blend[..., None] * now_rgb + (1.0 - blend)[..., None] * prev_rgb

        passthrough = sky | (frame == 0)
        return torch.where(passthrough[..., None], cur_color, out)
