"""The reference's numpy scene inputs: the env-map cache, the procedural
env map and the material rows.

Frozen copies of tpuray_torch/scene/host.py's env_cache_py,
procedural_room_envmap and material_table_arrays (the reference works the
env cache out again instead of taking the program's).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

MATERIAL_DEFAULTS = dict(
    emissive=(0.0, 0.0, 0.0), base_color=(1.0, 1.0, 1.0), subsurface=0.0,
    metallic=0.0, specular=0.5, specular_tint=0.0, roughness=0.5,
    anisotropic=0.0, sheen=0.0, sheen_tint=0.5, clearcoat=0.0,
    clearcoat_gloss=1.0, ior=1.0, transmission=0.0,
)


def material_table_arrays(materials: Sequence[dict]) -> dict[str, np.ndarray]:
    """Rows with defaults filled -> {"materials.<field>": f32 array}."""
    rows = [dict(MATERIAL_DEFAULTS, **m) for m in materials]
    return {f"materials.{k}": np.asarray([r[k] for r in rows], np.float32)
            for k in MATERIAL_DEFAULTS}


def env_cache_py(rgb: np.ndarray) -> np.ndarray:
    """(sample_x, sample_y, pdf) inverse-CDF cache; float64 internals."""
    rgb = np.asarray(rgb, np.float64)
    h, w = rgb.shape[:2]
    lum = 0.2 * rgb[..., 0] + 0.7 * rgb[..., 1] + 0.1 * rgb[..., 2]
    total = lum.sum()
    if total <= 0:
        raise ValueError("zero-luminance envmap")
    pdf = lum / total
    pdf_x = pdf.sum(axis=0)  # (w,)
    cdf_x = np.cumsum(pdf_x)
    denom = np.where(pdf_x > 0, pdf_x, 1.0)
    cdf_y = np.cumsum(pdf / denom[None, :], axis=0)  # (h, w)

    xi_1 = np.arange(h, dtype=np.float64) / h
    x = np.minimum(np.searchsorted(cdf_x, xi_1, side="left"), w - 1)  # (h,)
    xi_2 = np.arange(w, dtype=np.float64) / w
    cols = cdf_y[:, x]  # column x[i] of the conditional CDF, per row i
    y = np.empty((h, w), np.int64)
    for i in range(h):
        y[i] = np.searchsorted(cols[:, i], xi_2, side="left")
    y = np.minimum(y, h - 1)
    cache = np.empty((h, w, 3), np.float32)
    cache[..., 0] = (x[:, None].astype(np.float64) / w).astype(np.float32)
    cache[..., 1] = (y.astype(np.float64) / h).astype(np.float32)
    cache[..., 2] = pdf.astype(np.float32)
    return cache


def procedural_room_envmap(width: int = 512) -> np.ndarray:
    """A synthetic 'room' HDR: sky-like gradient, a bright window patch, a
    warm lamp blob and a dim floor."""
    h = width // 2
    v = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]  # 0=up
    u = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :]
    img = np.zeros((h, width, 3), np.float32)
    img[..., 0] = 0.35 * (1.0 - 0.7 * v)
    img[..., 1] = 0.40 * (1.0 - 0.6 * v)
    img[..., 2] = 0.50 * (1.0 - 0.5 * v)
    win = np.exp(-(((u - 0.25) / 0.06) ** 2 + ((v - 0.45) / 0.12) ** 2))
    img += win[..., None] * np.array([18.0, 20.0, 24.0], np.float32)
    lamp = np.exp(-(((u - 0.7) / 0.03) ** 2 + ((v - 0.2) / 0.05) ** 2))
    img += lamp[..., None] * np.array([40.0, 28.0, 12.0], np.float32)
    floor = (v > 0.62).astype(np.float32)
    img = img * (1 - floor[..., None]) + floor[..., None] * np.array([0.20, 0.15, 0.10])
    return img
