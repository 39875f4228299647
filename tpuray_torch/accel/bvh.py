"""BVH construction front end (counterpart of tpuray/accel/bvh.py).

A sweep-SAH threaded BVH (depth-first preorder with skip links) from the
native builder (io/native.py) when its library loads, else from the numpy
builder scene/host.py:build_bvh_py, which it equals up to the boxes' last
bits (tests/test_torch_native.py).
"""
from __future__ import annotations

import numpy as np

from tpuray_torch.io import native
from tpuray_torch.scene.host import build_bvh_py


def build_bvh(tri_verts: np.ndarray, leaf_size: int = 8, force_py: bool = False) -> dict:
    """tri_verts: (T, 3, 3) float32 -> dict(aabb_min, aabb_max, first_tri,
    tri_count, skip, perm) numpy arrays; perm maps the leaf-order index to
    the original triangle index. force_py takes the numpy builder."""
    tri_verts = np.ascontiguousarray(tri_verts, np.float32)
    out = None if force_py else native.build_bvh_native(tri_verts, leaf_size)
    if out is None:
        out = build_bvh_py(tri_verts, leaf_size)
    return out
