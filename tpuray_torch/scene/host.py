"""Numpy host builders for the scene: BVH, env-map cache, procedural env map,
material table.

Copies of tpuray/io/fallback.py:build_bvh_py and :env_cache_py,
tpuray/scene/builder.py:procedural_room_envmap and the row defaults of
:make_material_table. The GPU machine has no jax, and any import of the
JAX package pulls jax in (tpuray/__init__.py), so the port carries these
copies; tests/test_torch_scene.py holds each equal to its original.
ROADMAP.md item 16 (a jax-free host module inside tpuray/) removes them.
"""
from __future__ import annotations

import sys
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


def build_bvh_py(tri_verts: np.ndarray, leaf_size: int = 8) -> dict:
    """Sweep-SAH threaded BVH (DFS preorder + skip links)."""
    v = np.asarray(tri_verts, np.float32).reshape(-1, 3, 3)
    t = v.shape[0]
    cmin = v.min(axis=1)
    cmax = v.max(axis=1)
    centroid = v.mean(axis=1, dtype=np.float32)

    aabb_min, aabb_max = [], []
    first_tri, tri_count = [], []
    perm = np.arange(t, dtype=np.int32)

    def surface_area(mn, mx):
        d = mx - mn
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])

    def build(lo, hi):  # half-open [lo, hi)
        idx = perm[lo:hi]
        aabb_min.append(cmin[idx].min(axis=0))
        aabb_max.append(cmax[idx].max(axis=0))
        n = hi - lo
        if n <= leaf_size:
            first_tri.append(lo)
            tri_count.append(n)
            return
        first_tri.append(0)
        tri_count.append(0)

        best = (np.inf, -1, 0, None)
        for axis in range(3):
            order = idx[np.argsort(centroid[idx, axis], kind="stable")]
            pre_min = np.minimum.accumulate(cmin[order], axis=0)
            pre_max = np.maximum.accumulate(cmax[order], axis=0)
            suf_min = np.minimum.accumulate(cmin[order][::-1], axis=0)[::-1]
            suf_max = np.maximum.accumulate(cmax[order][::-1], axis=0)[::-1]
            counts = np.arange(1, n, dtype=np.float32)
            cost = (surface_area(pre_min[:-1], pre_max[:-1]) * counts
                    + surface_area(suf_min[1:], suf_max[1:]) * counts[::-1])
            i = int(np.argmin(cost))
            if cost[i] < best[0]:
                best = (float(cost[i]), axis, i, order)
        _, _, i, order = best
        perm[lo:hi] = order
        build(lo, lo + i + 1)
        build(lo + i + 1, hi)

    if t > 0:
        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 10000 + t))
        try:
            build(0, t)
        finally:
            sys.setrecursionlimit(old_limit)

    n_nodes = len(first_tri)
    tri_count_a = np.asarray(tri_count, np.int32)
    # skip links from subtree extents (one forward pass)
    end = np.zeros(n_nodes, np.int64)
    st: list[list[int]] = []
    for i in range(n_nodes):
        if tri_count_a[i] == 0:
            st.append([i, 0])
        else:
            end[i] = i + 1
            last_end = end[i]
            while st:
                st[-1][1] += 1
                if st[-1][1] == 2:
                    node = st.pop()[0]
                    end[node] = last_end
                    last_end = end[node]
                else:
                    break
    return dict(
        aabb_min=np.asarray(aabb_min, np.float32).reshape(n_nodes, 3),
        aabb_max=np.asarray(aabb_max, np.float32).reshape(n_nodes, 3),
        first_tri=np.asarray(first_tri, np.int32),
        tri_count=tri_count_a,
        skip=end.astype(np.int32),
        perm=perm,
    )


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
