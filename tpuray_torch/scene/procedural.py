"""Procedural test geometry — scenes with no file dependencies.

Counterpart of tpuray/scene/procedural.py (icosphere, ground_quad,
make_test_scene, make_large_scene), built as the JAX package builds them:
the BVH by accel/bvh.py and the env cache by scene/builder.py's
make_env_cache, native first.
"""
from __future__ import annotations

import numpy as np

from tpuray_torch.accel.bvh import build_bvh
from tpuray_torch.io.obj import write_obj
from tpuray_torch.scene.builder import make_env_cache
from tpuray_torch.scene.host import material_table_arrays, procedural_room_envmap
from tpuray_torch.scene.partition import apply_perm_padded, build_forest_bvh_uniform
from tpuray_torch.scene.types import Scene, scene_from_numpy


def icosphere(subdiv: int = 2, radius: float = 0.5, center=(0, 0, 0)) -> np.ndarray:
    """(T, 3, 3) triangle vertices of a subdivided icosahedron."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdiv):
        new_faces = []
        mids: dict[tuple[int, int], int] = {}
        verts_l = verts.tolist()

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = (np.asarray(verts_l[a]) + np.asarray(verts_l[b])) / 2
                m = m / np.linalg.norm(m)
                mids[key] = len(verts_l)
                verts_l.append(m.tolist())
            return mids[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_l)
        faces = np.asarray(new_faces)
    tri = verts[faces] * radius + np.asarray(center)
    return tri.astype(np.float32)


def ground_quad(y: float = -0.5, half: float = 4.0) -> np.ndarray:
    a = [-half, y, -half]
    b = [half, y, -half]
    c = [half, y, half]
    d = [-half, y, half]
    return np.asarray([[a, b, c], [a, c, d]], np.float32)


def make_test_scene_arrays(subdiv: int = 2, with_lights: bool = True,
                           env_width: int = 128, leaf_size: int = 8
                           ) -> dict[str, np.ndarray]:
    """Sphere on a ground plane under the procedural room envmap, as the
    flat numpy arrays that scene_from_numpy takes."""
    sphere = icosphere(subdiv)
    ground = ground_quad()
    tris = np.concatenate([sphere, ground])
    mat_id = np.concatenate([
        np.zeros(len(sphere), np.int32), np.ones(len(ground), np.int32)])

    bvh = build_bvh(tris, leaf_size)
    perm = bvh["perm"]
    tris = tris[perm]
    mat_id = mat_id[perm]

    # smooth normals for the sphere (= normalized positions), flat for ground
    normals = np.empty_like(tris)
    for k in range(3):
        v = tris[:, k, :]
        sphere_n = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
        normals[:, k, :] = np.where(
            (mat_id == 0)[:, None], sphere_n, np.asarray([0.0, 1.0, 0.0]))

    uvs = np.zeros((len(tris), 3, 2), np.float32)
    uvs[:, 1, 0] = 1.0
    uvs[:, 2, 1] = 1.0

    arrays = {}
    for k in range(3):
        arrays[f"triangles.p{k}"] = tris[:, k]
        arrays[f"triangles.n{k}"] = normals[:, k]
        arrays[f"triangles.uv{k}"] = uvs[:, k]
    arrays["triangles.mat_id"] = mat_id
    arrays["triangles.obj_id"] = mat_id
    for key in ("aabb_min", "aabb_max", "first_tri", "tri_count", "skip"):
        arrays[f"bvh.{key}"] = bvh[key]
    arrays.update(material_table_arrays([
        dict(base_color=(0.8, 0.3, 0.25), roughness=0.35, metallic=0.1,
             clearcoat=0.5, specular=0.5),
        dict(base_color=(0.55, 0.55, 0.6), roughness=0.8),
    ]))
    if with_lights:
        arrays["lights.position"] = np.asarray(
            [[1.0, 1.2, 1.0], [-1.2, 0.8, 0.5]], np.float32)
        arrays["lights.radiance"] = np.asarray(
            [[6.0, 6.0, 5.0], [2.0, 2.5, 4.0]], np.float32)
    else:
        arrays["lights.position"] = np.zeros((0, 3), np.float32)
        arrays["lights.radiance"] = np.zeros((0, 3), np.float32)
    env_img = procedural_room_envmap(env_width)
    arrays["envmap.image"] = env_img
    arrays["envmap.cache"] = make_env_cache(env_img)
    return arrays


def write_test_scene_obj(path: str, subdiv: int = 2) -> None:
    """make_test_scene's geometry (an icosphere on a ground quad) as one OBJ
    with shared vertices (smooth normals on load) and non-constant texture
    coordinates: spherical on the sphere, planar on the ground."""
    tris = np.concatenate([icosphere(subdiv), ground_quad()])
    verts, faces = np.unique(tris.reshape(-1, 3), axis=0, return_inverse=True)
    faces = faces.reshape(-1, 3)
    p = tris.reshape(-1, 3).astype(np.float64)
    on_sphere = np.repeat(np.arange(len(tris)) < len(tris) - 2, 3)
    r = np.linalg.norm(p, axis=-1)
    u = np.where(on_sphere, 0.5 + np.arctan2(p[:, 2], p[:, 0]) / (2 * np.pi),
                 (p[:, 0] + 4.0) / 8.0)
    v = np.where(on_sphere, 0.5 + np.arcsin(np.clip(p[:, 1] / np.maximum(r, 1e-9), -1, 1))
                 / np.pi, (p[:, 2] + 4.0) / 8.0)
    write_obj(path, verts, faces, np.stack([u, v], -1).astype(np.float32),
              np.arange(len(p)).reshape(-1, 3))


def make_test_scene(subdiv: int = 2, with_lights: bool = True,
                    env_width: int = 128, leaf_size: int = 8,
                    device="cpu") -> Scene:
    """make_test_scene_arrays, as a torch Scene on `device`."""
    return scene_from_numpy(
        make_test_scene_arrays(subdiv, with_lights, env_width, leaf_size),
        device)


def make_large_scene_arrays(n_spheres: int = 25, subdiv: int = 3,
                            max_chunk_tris: int = 8192, leaf_size: int = 8,
                            env_width: int = 128, seed: int = 11
                            ) -> dict[str, np.ndarray]:
    """n_spheres icospheres of 20*4^subdiv triangles on a ground quad, as a
    uniform chunked forest (scene/partition.py), in scene_from_numpy's
    arrays. 25 spheres: subdiv 3 ~= 32k triangles, 4 ~= 128k, 5 ~= 512k."""
    rs = np.random.RandomState(seed)
    blobs = []
    for i in range(n_spheres):
        r = 0.12 + 0.18 * rs.rand()
        c = (rs.rand(3) - 0.5) * np.asarray([3.0, 1.2, 3.0])
        c[1] = max(c[1], -0.5 + r)
        blobs.append(icosphere(subdiv, radius=r, center=tuple(c)))
    ground = ground_quad()
    tris = np.concatenate(blobs + [ground]).astype(np.float32)
    mat_id = np.concatenate(
        [np.full(len(b), i % 2, np.int32) for i, b in enumerate(blobs)]
        + [np.ones(len(ground), np.int32)])

    centers = np.concatenate(
        [np.tile(b.mean(axis=(0, 1)), (len(b), 1)) for b in blobs]
        + [np.zeros((len(ground), 3), np.float32)]).astype(np.float32)

    f = build_forest_bvh_uniform(tris, leaf_size, max_chunk_tris)
    perm = f["perm"]
    tris_p = apply_perm_padded(tris, perm)
    mat_p = apply_perm_padded(mat_id, perm).astype(np.int32)
    ctr_p = apply_perm_padded(centers, perm)

    # smooth sphere normals (= direction from the blob center); material 1
    # (odd spheres and the ground) gets the flat ground normal, as in the
    # JAX package
    normals = np.empty_like(tris_p)
    for k in range(3):
        v = tris_p[:, k, :] - ctr_p
        n = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
        normals[:, k, :] = np.where((mat_p == 1)[:, None],
                                    np.asarray([0.0, 1.0, 0.0]), n)

    uvs = np.zeros((len(tris_p), 3, 2), np.float32)
    uvs[:, 1, 0] = 1.0
    uvs[:, 2, 1] = 1.0

    arrays = {}
    for k in range(3):
        arrays[f"triangles.p{k}"] = tris_p[:, k]
        arrays[f"triangles.n{k}"] = normals[:, k]
        arrays[f"triangles.uv{k}"] = uvs[:, k]
    arrays["triangles.mat_id"] = mat_p
    arrays["triangles.obj_id"] = mat_p
    for key in ("aabb_min", "aabb_max", "first_tri", "tri_count", "skip"):
        arrays[f"bvh.{key}"] = f[key]
    arrays["bvh.chunk_nodes"] = np.asarray(f["chunk_nodes"])
    arrays["bvh.chunk_tris"] = np.asarray(f["chunk_tris"])
    arrays.update(material_table_arrays([
        dict(base_color=(0.75, 0.35, 0.3), roughness=0.4, metallic=0.2),
        dict(base_color=(0.5, 0.55, 0.65), roughness=0.7),
    ]))
    arrays["lights.position"] = np.asarray([[2.0, 2.2, 2.0]], np.float32)
    arrays["lights.radiance"] = np.asarray([[20.0, 19.0, 17.0]], np.float32)
    env_img = procedural_room_envmap(env_width)
    arrays["envmap.image"] = env_img
    arrays["envmap.cache"] = make_env_cache(env_img)
    return arrays


def make_large_scene(n_spheres: int = 25, subdiv: int = 3,
                     max_chunk_tris: int = 8192, leaf_size: int = 8,
                     env_width: int = 128, seed: int = 11,
                     device="cpu") -> Scene:
    """make_large_scene_arrays, as a torch Scene on `device`."""
    return scene_from_numpy(
        make_large_scene_arrays(n_spheres, subdiv, max_chunk_tris, leaf_size,
                                env_width, seed), device)
