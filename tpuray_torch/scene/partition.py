"""Spatial scene partitioning: a forest of chunk BVHs for large scenes.

A numpy copy of tpuray/scene/partition.py (the port cannot import the JAX
package, whose __init__ pulls in jax), built with scene/host.py's
build_bvh_py; tests/test_torch_partition.py holds it equal to the
original. The uniform layout is what kernels/trace_chunked.py (K6) walks:

  - chunk c owns node rows [c*CN, (c+1)*CN) and triangle rows
    [c*CT, (c+1)*CT); shorter chunks are padded;
  - first_tri and skip are global indices, and chunk c's root skips to
    chunk c+1's root, so the skip-link wavefront of integrator/intersect.py
    walks the whole forest unchanged (the plain version of K6).
"""
from __future__ import annotations

import numpy as np

from tpuray_torch.scene.host import build_bvh_py


def partition_triangles(tri_verts: np.ndarray, max_tris: int) -> list[np.ndarray]:
    """Recursive median split of triangle indices by centroid on the widest
    axis. Returns index arrays (original order kept within each part), each
    of length <= max_tris. Deterministic."""
    centers = tri_verts.mean(axis=1)  # (T, 3)
    out: list[np.ndarray] = []

    def rec(idx: np.ndarray) -> None:
        if len(idx) <= max_tris:
            out.append(idx)
            return
        c = centers[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = len(idx) // 2
        rec(idx[order[:half]])
        rec(idx[order[half:]])

    rec(np.arange(len(tri_verts)))
    return out


def build_forest_bvh(tri_verts: np.ndarray, leaf_size: int = 8,
                     max_chunk_tris: int = 8192) -> dict:
    """Packed (unpadded) forest: build_bvh_py's arrays plus chunk_node_base
    and chunk_tri_base (C+1,) int32; first_tri and skip are global."""
    tri_verts = np.ascontiguousarray(tri_verts, np.float32)
    parts = partition_triangles(tri_verts, max_chunk_tris)

    mins, maxs, firsts, counts, skips, perms = [], [], [], [], [], []
    node_base = [0]
    tri_base = [0]
    for idx in parts:
        b = build_bvh_py(tri_verts[idx], leaf_size)
        nb, tb = node_base[-1], tri_base[-1]
        mins.append(b["aabb_min"])
        maxs.append(b["aabb_max"])
        firsts.append(b["first_tri"] + tb)
        counts.append(b["tri_count"])
        skips.append(b["skip"] + nb)
        perms.append(idx[b["perm"]])
        node_base.append(nb + len(b["skip"]))
        tri_base.append(tb + len(idx))

    return {
        "aabb_min": np.concatenate(mins),
        "aabb_max": np.concatenate(maxs),
        "first_tri": np.concatenate(firsts).astype(np.int32),
        "tri_count": np.concatenate(counts).astype(np.int32),
        "skip": np.concatenate(skips).astype(np.int32),
        "perm": np.concatenate(perms),
        "chunk_node_base": np.asarray(node_base, np.int32),
        "chunk_tri_base": np.asarray(tri_base, np.int32),
    }


def build_forest_bvh_uniform(tri_verts: np.ndarray, leaf_size: int = 8,
                             max_chunk_tris: int = 8192) -> dict:
    """Uniform (padded) forest layout.

    Padding nodes have an inverted AABB (min +FLT_MAX, max -FLT_MAX) and
    skip to the next chunk root. The slab test is order-agnostic, so it
    enters such a box: the skip-link walk steps through a chunk's padding
    nodes one at a time; a DFS from the chunk root never reaches them.
    Padding triangle slots have perm == -1 and get all-zero (degenerate)
    geometry from apply_perm_padded.

    Returns build_forest_bvh's dict plus "chunk_nodes"/"chunk_tris" ints
    (multiples of 128, the JAX package's stride); first_tri and skip are
    global indices into the padded arrays."""
    tri_verts = np.ascontiguousarray(tri_verts, np.float32)
    parts = partition_triangles(tri_verts, max_chunk_tris)
    builds = [build_bvh_py(tri_verts[idx], leaf_size) for idx in parts]

    def up128(x: int) -> int:
        return (x + 127) // 128 * 128

    cn = up128(max(len(b["skip"]) for b in builds))
    ct = up128(max(len(p) for p in parts))
    c = len(parts)

    aabb_min = np.full((c * cn, 3), np.float32(np.finfo(np.float32).max))
    aabb_max = np.full((c * cn, 3), np.float32(-np.finfo(np.float32).max))
    first = np.zeros(c * cn, np.int32)
    count = np.zeros(c * cn, np.int32)
    skip = np.empty(c * cn, np.int32)
    perm = np.full(c * ct, -1, np.int64)

    for ci, (idx, b) in enumerate(zip(parts, builds)):
        nb, tb = ci * cn, ci * ct
        sz = len(b["skip"])
        aabb_min[nb: nb + sz] = b["aabb_min"]
        aabb_max[nb: nb + sz] = b["aabb_max"]
        first[nb: nb + sz] = b["first_tri"] + tb
        count[nb: nb + sz] = b["tri_count"]
        skip[nb: nb + sz] = b["skip"] + nb
        skip[nb + sz: nb + cn] = (ci + 1) * cn  # padding: step to next chunk
        perm[tb: tb + len(idx)] = idx[b["perm"]]

    base = np.arange(c + 1, dtype=np.int64)
    return {
        "aabb_min": aabb_min, "aabb_max": aabb_max,
        "first_tri": first, "tri_count": count, "skip": skip,
        "perm": perm,
        "chunk_node_base": (base * cn).astype(np.int32),
        "chunk_tri_base": (base * ct).astype(np.int32),
        "chunk_nodes": cn, "chunk_tris": ct,
    }


def apply_perm_padded(arr: np.ndarray, perm: np.ndarray,
                      fill: float = 0.0) -> np.ndarray:
    """Reorder per-triangle attributes by a padded perm (-1 = padding slot,
    filled with `fill`; zero geometry never intersects)."""
    out = np.full((len(perm),) + arr.shape[1:], fill, arr.dtype)
    real = perm >= 0
    out[real] = arr[perm[real]]
    return out
