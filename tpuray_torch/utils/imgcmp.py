"""Image-comparison utilities for the golden harness (counterpart of
tpuray/utils/imgcmp.py, a copy: importing tpuray pulls in jax).

The reference's de-facto verification surface is five full-window
screenshots in result/*.png (README.md:5-14): an 800x800 GL viewport under a
~37px title bar, with imgui panels overlaid in the lower third. These
utilities let us compare our renders against that surface quantitatively:
luminance SSIM, gradient normalized cross-correlation, and a small
integer-offset alignment search (to discover the viewport origin inside the
screenshot). All pure numpy — this is host-side tooling, not device code.
"""
from __future__ import annotations

import numpy as np


def luminance(img: np.ndarray) -> np.ndarray:
    """Rec.601-ish luma, matching the reference's tonemap weights
    (output_pass.frag:14)."""
    img = np.asarray(img, np.float32)
    return 0.3 * img[..., 0] + 0.6 * img[..., 1] + 0.1 * img[..., 2]


def _box(img: np.ndarray, r: int) -> np.ndarray:
    """(2r+1)^2 box filter via 2D cumsum, edge-padded. float64 accumulation:
    float32 cumsums over megapixel images lose the low bits that the
    variance subtraction below needs."""
    pad = np.pad(img.astype(np.float64), r, mode="edge")
    c = pad.cumsum(0).cumsum(1)
    c = np.pad(c, ((1, 0), (1, 0)))
    k = 2 * r + 1
    s = (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k])
    return s / (k * k)


def ssim(a: np.ndarray, b: np.ndarray, radius: int = 3,
         dynamic_range: float = 1.0) -> float:
    """Mean SSIM over a luminance pair (box window)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    c1 = (0.01 * dynamic_range) ** 2
    c2 = (0.03 * dynamic_range) ** 2
    mu_a, mu_b = _box(a, radius), _box(b, radius)
    # cumsum catastrophic cancellation can push variances slightly negative
    # (and with them SSIM outside [-1, 1]); clamp
    va = np.maximum(_box(a * a, radius) - mu_a ** 2, 0.0)
    vb = np.maximum(_box(b * b, radius) - mu_b ** 2, 0.0)
    cov = _box(a * b, radius) - mu_a * mu_b
    cov = np.clip(cov, -np.sqrt(va * vb), np.sqrt(va * vb))
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
         / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)))
    return float(s.mean())


def grad_mag(img: np.ndarray) -> np.ndarray:
    """Forward-difference gradient magnitude of a 2D field."""
    gy = np.diff(img, axis=0, append=img[-1:])
    gx = np.diff(img, axis=1, append=img[:, -1:])
    return np.hypot(gx, gy)


def ncc(a: np.ndarray, b: np.ndarray) -> float:
    """Normalized cross-correlation of two equal-shape fields."""
    a = a - a.mean()
    b = b - b.mean()
    d = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / d) if d > 0 else 0.0


def best_offset(ours: np.ndarray, screenshot: np.ndarray,
                search: int = 48, step: int = 1,
                metric=ncc) -> tuple[tuple[int, int], float]:
    """Find the (dy, dx) placement of `ours` (H, W) inside `screenshot`
    (>=H+search, >=W) maximizing `metric` on gradient magnitudes.
    Returns ((dy, dx), score)."""
    go = grad_mag(ours)
    gs = grad_mag(screenshot)
    h, w = go.shape
    best, best_s = (0, 0), -np.inf
    for dy in range(0, min(search, gs.shape[0] - h) + 1, step):
        for dx in range(0, min(search, gs.shape[1] - w) + 1, step):
            s = metric(go, gs[dy:dy + h, dx:dx + w])
            if s > best_s:
                best, best_s = (dy, dx), s
    return best, float(best_s)
