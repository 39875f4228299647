# The benchmark's reference: a frozen copy of tpuray_torch/denoise/common.py (its
# imports pointed here). The program may change; this copy does not.
"""Shared image-space helpers of the denoiser stages (counterpart of
tpuray/denoise/common.py)."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def luminance(c: Tensor) -> Tensor:
    """Rec. 709-ish luma of the SVGF stages (svgf_reproject.frag:158-160)."""
    return 0.2125 * c[..., 0] + 0.7154 * c[..., 1] + 0.0721 * c[..., 2]


def dot3(a: Tensor, b: Tensor) -> Tensor:
    """a . b over the last axis, summed left to right as the kernels do."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm3(v: Tensor) -> Tensor:
    return torch.sqrt(dot3(v, v))


def rdiv(a: float, t: Tensor) -> Tensor:
    """a / t as one IEEE division (PyTorch's `a / t` for a Python scalar a
    computes reciprocal(t) * a, which rounds twice)."""
    return torch.full_like(t, a) / t


def shift2d(img: Tensor, dy: int, dx: int) -> Tensor:
    """out[y, x] = img[clamp(y + dy), clamp(x + dx)]: a static-offset
    neighbour fetch with clamp-to-edge."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img.index_select(0, ys).index_select(1, xs)


def inside_mask(shape: tuple[int, int], dy: int, dx: int, device=None) -> Tensor:
    """True where pixel (y + dy, x + dx) lies inside the image."""
    h, w = shape
    ys = torch.arange(h, device=device) + dy
    xs = torch.arange(w, device=device) + dx
    return ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None, :]


def pow_weight(x: Tensor, sigma: float) -> Tensor:
    """clamp(x, 0, 1) ** sigma; repeated squaring when sigma is a power of
    two (the default sigma_n = 128: seven multiplies), as the kernels do."""
    x = torch.clamp(x, 0.0, 1.0)
    n = squarings(sigma)
    if n is None:
        return torch.pow(x, float(sigma))
    for _ in range(n):
        x = x * x
    return x


def squarings(sigma: float) -> int | None:
    """log2(sigma) if sigma is a positive integer power of two, else None."""
    s = float(sigma)
    if s > 0 and s == int(s) and (int(s) & (int(s) - 1)) == 0:
        return int(s).bit_length() - 1
    return None
