# The benchmark's reference: a frozen copy of tpuray_torch/sampling/envmap.py (its
# imports pointed here). The program may change; this copy does not.
"""HDR environment light: direction mapping, radiance lookup, importance
sampling from the inverse-CDF cache, solid-angle pdf and the one-gather NEE
table (counterpart of tpuray/sampling/envmap.py).

The JAX package's quad-packed fetches (env_radiance_packed,
sample_env_packed, env_pdf_packed) are a TPU gather layout with the same
values as `env_radiance`, `sample_env` and `env_pdf`; the port fetches the
four texels directly.
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor
PI = np.float32(np.pi)
_TWO_PI = float(np.float32(2.0) * PI)
_PI = float(PI)


def bilinear_fetch(img: Tensor, u: Tensor, v: Tensor) -> Tensor:
    """GL_LINEAR / GL_CLAMP_TO_EDGE fetch: img (H, W, C); u indexes width,
    v height, texel centers at (i + 0.5)/N. Returns (*uv_shape, C)."""
    h, w = img.shape[0], img.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    c00 = img[y0i, x0i]
    c10 = img[y0i, x1i]
    c01 = img[y1i, x0i]
    c11 = img[y1i, x1i]
    fx = fx[..., None]
    fy = fy[..., None]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def dir_to_uv(d: Tensor) -> tuple[Tensor, Tensor]:
    """Equirect direction -> (u, v): u = atan2(z, x)/2pi + 0.5,
    v = 1 - (asin(y)/pi + 0.5)."""
    n2 = torch.sum(d * d, dim=-1, keepdim=True)
    d = d * torch.rsqrt(torch.clamp_min(n2, 1e-24))
    u = torch.atan2(d[..., 2], d[..., 0]) / _TWO_PI + 0.5
    v = 1.0 - (torch.asin(torch.clamp(d[..., 1], -1.0, 1.0)) / _PI + 0.5)
    return u, v


def env_radiance(image: Tensor, d: Tensor) -> Tensor:
    """Bilinear-fetch the envmap in direction d."""
    u, v = dir_to_uv(d)
    return bilinear_fetch(image, u, v)


def sample_env(cache: Tensor, xi1: Tensor, xi2: Tensor) -> Tensor:
    """Env-map light sample: xi -> world direction (..., 3). Fetches
    (inv_cdf_x, inv_cdf_y) bilinearly from the cache at (u=xi1, v=xi2):
    xi2 selects the column marginal, xi1 the row conditional."""
    xy = bilinear_fetch(cache, xi1, xi2)[..., :2]
    x = xy[..., 0]
    y = 1.0 - xy[..., 1]
    phi = _TWO_PI * (x - 0.5)
    theta = _PI * (y - 0.5)
    ct = torch.cos(theta)
    return torch.stack([ct * torch.cos(phi), torch.sin(theta), ct * torch.sin(phi)],
                       dim=-1)


def env_pdf(cache: Tensor, d: Tensor) -> Tensor:
    """Solid-angle pdf of direction d under the texel-mass sampling scheme:
    pdf_texel * W*H / (2 pi^2 cos(elevation))."""
    u, v = dir_to_uv(d)
    pdf = bilinear_fetch(cache, u, v)[..., 2]
    theta = _PI * (0.5 - v)
    jac = torch.clamp_min(torch.cos(theta), 1e-10)
    wh = float(np.float32(cache.shape[0] * cache.shape[1]))
    convert = wh / (float(np.float32(2.0) * PI * PI) * jac)
    return pdf * convert


def build_env_cache(image: Tensor) -> Tensor:
    """The (H, W, 3) inverse-CDF cache (sample_x, sample_y, pdf) of an
    (H, W, 3) env map, built on the image's device in its dtype (a scene's
    is float32) by cumsum and searchsorted: the counterpart of
    build_env_cache_jnp, for an env map that is itself optimised. The host
    builders (scene/builder.py's make_env_cache) sum in float64."""
    h, w = image.shape[0], image.shape[1]
    dev = image.device
    lum = 0.2 * image[..., 0] + 0.7 * image[..., 1] + 0.1 * image[..., 2]
    pdf = lum / torch.sum(lum)
    pdf_x = torch.sum(pdf, dim=0)
    cdf_x = torch.cumsum(pdf_x, dim=0)
    denom = torch.where(pdf_x > 0, pdf_x, 1.0)
    cdf_y = torch.cumsum(pdf / denom[None, :], dim=0)  # (h, w)

    xi1 = torch.arange(h, dtype=torch.float32, device=dev) / h
    x = torch.clamp(torch.searchsorted(cdf_x, xi1, side="left"), 0, w - 1)  # (h,)
    xi2 = torch.arange(w, dtype=torch.float32, device=dev) / w
    cols = cdf_y[:, x].T.contiguous()  # row i: the conditional CDF of column x[i]
    y = torch.searchsorted(cols, xi2.expand(h, w).contiguous(), side="left")
    y = torch.clamp(y, 0, h - 1)  # (h, w)
    return torch.stack([(x.to(torch.float32) / w)[:, None].expand(h, w),
                        y.to(torch.float32) / h, pdf], dim=-1)


def pack_env_nee_table(image: Tensor, cache: Tensor) -> Tensor:
    """(H, W, 8) rows [Lx, Ly, Lz, Rr, Rg, Rb, pdf_omega, 0]: the sampled
    direction of each cache texel with its radiance and pdf."""
    x = cache[..., 0]
    y = 1.0 - cache[..., 1]
    phi = _TWO_PI * (x - 0.5)
    theta = _PI * (y - 0.5)
    ct = torch.cos(theta)
    l = torch.stack([ct * torch.cos(phi), torch.sin(theta), ct * torch.sin(phi)],
                    dim=-1)
    rad = env_radiance(image, l)
    pdf = env_pdf(cache, l)
    return torch.cat([l, rad, pdf[..., None], torch.zeros_like(pdf)[..., None]],
                     dim=-1)


def sample_env_nee(table: Tensor, xi1: Tensor, xi2: Tensor
                   ) -> tuple[Tensor, Tensor, Tensor]:
    """One row fetch -> (direction (..., 3), radiance (..., 3), pdf (...)).
    Nearest-texel inverse-CDF draw; xi1 indexes width, xi2 height."""
    h, w = table.shape[0], table.shape[1]
    cx = torch.clamp((xi1 * w).to(torch.int64), 0, w - 1)
    cy = torch.clamp((xi2 * h).to(torch.int64), 0, h - 1)
    row = table.reshape(h * w, 8)[cy * w + cx]
    return row[..., 0:3], row[..., 3:6], row[..., 6]
