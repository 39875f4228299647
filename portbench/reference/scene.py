"""The benchmark's scene inputs, and the reference's own scene built from them.

Input generators, frozen copies of the program's (tpuray_torch/scene/
procedural.py's icosphere, ground_quad and write_test_scene_obj,
io/obj.py:write_obj, scene/builder.py:procedural_texture_layers): the
harness writes the OBJ and makes the texture layers and the env map, and
hands the same to the program and to the reference. The test scene and
the forest are recipes (make_test_scene's and make_large_scene's
parameters) that the program and test_scene and sphere_forest below both
follow.

The reference builds its triangles from the OBJ file with a numpy copy of
the program's loader (io/fallback.py:parse_obj_py, io/obj.py:load_obj),
keeps them in file order (no BVH: trace.py culls by clusters), and works
the env-map cache and the NEE table out again (host.py, envmap.py).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import envmap
from portbench.reference.host import env_cache_py, material_table_arrays
from portbench.reference.shade import MATERIAL_FIELDS, RefScene
from portbench.reference.trace import Clusters


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


def write_obj(path: str, positions: np.ndarray, faces: np.ndarray,
              texcoords: np.ndarray, face_texcoords: np.ndarray) -> None:
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in np.asarray(positions, np.float64).tolist()]
    lines += [f"vt {u!r} {v!r}" for u, v in np.asarray(texcoords, np.float64).tolist()]
    ft = np.asarray(face_texcoords, np.int64).tolist()
    lines += [f"f {a + 1}/{ta + 1} {b + 1}/{tb + 1} {c + 1}/{tc + 1}"
              for (a, b, c), (ta, tb, tc) in zip(np.asarray(faces, np.int64).tolist(), ft)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_test_scene_obj(path: str, subdiv: int) -> None:
    """An icosphere on a ground quad as one OBJ with shared vertices and
    texture coordinates: spherical on the sphere, planar on the ground."""
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


def procedural_texture_layers(res: int = 256) -> dict:
    """Deterministic albedo, metallic, normal and roughness layers."""
    yy, xx = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res), indexing="ij")
    checker = ((np.floor(xx * 8) + np.floor(yy * 8)) % 2).astype(np.float32)
    albedo = np.stack([
        0.2 + 0.6 * checker, 0.3 + 0.3 * (1 - checker), 0.25 + 0.2 * np.sin(xx * 9)**2,
    ], axis=-1).astype(np.float32)
    metallic = np.repeat((0.1 + 0.8 * checker)[..., None], 3, axis=-1).astype(np.float32)
    rough_base = 0.3 + 0.5 * np.abs(np.sin(yy * 13))
    roughness = np.repeat(rough_base[..., None], 3, axis=-1).astype(np.float32)
    nrm = np.stack([
        0.5 + 0.08 * np.sin(xx * 40), 0.5 + 0.08 * np.cos(yy * 40),
        np.full_like(xx, 0.95),
    ], axis=-1).astype(np.float32)
    return dict(albedo=albedo, metallic=metallic, normal=nrm, roughness=roughness)


def parse_obj(path: str):
    """-> (positions (V, 3) f32, texcoords (VT, 2) f32, face vertex ids
    (F, 3), face texcoord ids (F, 3), -1 where absent)."""
    positions, texcoords, face_v, face_vt = [], [], [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v" and len(parts) >= 4:
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "vt" and len(parts) >= 3:
                texcoords.append([float(parts[1]), float(parts[2])])
            elif parts[0] == "f" and len(parts) >= 4:
                vi, ti = [], []
                for tok in parts[1:4]:
                    sub = tok.split("/")
                    vi.append(int(sub[0]) - 1)
                    ti.append(int(sub[1]) - 1 if len(sub) >= 2 and sub[1] else -1)
                face_v.append(vi)
                face_vt.append(ti)
    return (np.asarray(positions, np.float32).reshape(-1, 3),
            np.asarray(texcoords, np.float32).reshape(-1, 2),
            np.asarray(face_v, np.int32).reshape(-1, 3),
            np.asarray(face_vt, np.int32).reshape(-1, 3))


def transform_matrix(scale=(1, 1, 1)) -> np.ndarray:
    """The model transform of a scale alone (4x4 float64)."""
    return np.diag([scale[0], scale[1], scale[2], 1.0])


def load_obj(path: str, transform: np.ndarray) -> dict:
    """The OBJ normalised into a unit box, transformed, with smooth vertex
    normals -> per-triangle float32 positions, normals, uvs."""
    pos, uv, fv, fvt = parse_obj(path)
    pos = pos.astype(np.float64)
    pos = pos / float((pos.max(axis=0) - pos.min(axis=0)).max())
    pos = pos @ np.asarray(transform)[:3, :3].T + np.asarray(transform)[:3, 3]
    tri_p = pos[fv]
    e1 = tri_p[:, 1] - tri_p[:, 0]
    e2 = tri_p[:, 2] - tri_p[:, 0]
    fn = np.cross(e1, e2)
    fn_unit = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-30)
    vn = np.zeros_like(pos)
    for k in range(3):
        np.add.at(vn, fv[:, k], fn_unit)
    vn = vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-30)
    tri_uv = uv[np.where(fvt >= 0, fvt, 0)].astype(np.float32)
    return dict(positions=tri_p.astype(np.float32), normals=vn[fv].astype(np.float32),
                uvs=tri_uv)


def test_scene(subdiv: int) -> dict:
    """make_test_scene's geometry in its own order: an icosphere (material
    0, smooth normals from the origin) on a ground quad (material 1, the
    flat normal), constant uvs."""
    sphere = icosphere(subdiv)
    tris = np.concatenate([sphere, ground_quad()])
    mat = np.concatenate([np.zeros(len(sphere), np.int32), np.ones(2, np.int32)])
    normals = np.empty_like(tris)
    for k in range(3):
        v = tris[:, k, :]
        nn = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
        normals[:, k, :] = np.where((mat == 0)[:, None], nn, np.asarray([0.0, 1.0, 0.0]))
    uvs = np.zeros((len(tris), 3, 2), np.float32)
    uvs[:, 1, 0] = 1.0
    uvs[:, 2, 1] = 1.0
    return dict(positions=tris, normals=normals, uvs=uvs, mat_id=mat, obj_id=mat)


def sphere_forest(n_spheres: int, subdiv: int, seed: int) -> dict:
    """make_large_scene's geometry in its own order: n_spheres icospheres
    of random radius and centre from RandomState(seed) on a ground quad;
    smooth normals from each sphere's centre, the flat ground normal on
    material 1 (odd spheres and the ground), constant uvs."""
    rs = np.random.RandomState(seed)
    blobs = []
    for _ in range(n_spheres):
        r = 0.12 + 0.18 * rs.rand()
        c = (rs.rand(3) - 0.5) * np.asarray([3.0, 1.2, 3.0])
        c[1] = max(c[1], -0.5 + r)
        blobs.append(icosphere(subdiv, radius=r, center=tuple(c)))
    ground = ground_quad()
    tris = np.concatenate(blobs + [ground]).astype(np.float32)
    mat = np.concatenate([np.full(len(b), i % 2, np.int32) for i, b in enumerate(blobs)]
                         + [np.ones(len(ground), np.int32)])
    centers = np.concatenate([np.tile(b.mean(axis=(0, 1)), (len(b), 1)) for b in blobs]
                             + [np.zeros((len(ground), 3), np.float32)]).astype(np.float32)
    normals = np.empty_like(tris)
    for k in range(3):
        v = tris[:, k, :] - centers
        nn = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
        normals[:, k, :] = np.where((mat == 1)[:, None], np.asarray([0.0, 1.0, 0.0]), nn)
    uvs = np.zeros((len(tris), 3, 2), np.float32)
    uvs[:, 1, 0] = 1.0
    uvs[:, 2, 1] = 1.0
    return dict(positions=tris, normals=normals, uvs=uvs, mat_id=mat, obj_id=mat)


def build(spec: dict, obj_path: str | None, textures: dict | None,
          env_image: np.ndarray, device) -> RefScene:
    """The reference's scene from a configuration's "scene" entry and the
    inputs the harness made (the OBJ file, the texture layers, the env
    image)."""
    if spec["kind"] == "obj_file":
        geo = load_obj(obj_path, transform_matrix(spec["scale"]))
        t = len(geo["positions"])
        geo["mat_id"] = np.zeros(t, np.int32)
        geo["obj_id"] = np.zeros(t, np.int32)
        materials = [spec["material"]]
    elif spec["kind"] == "test_scene":
        geo = test_scene(spec["subdiv"])
        materials = spec["materials"]
    elif spec["kind"] == "sphere_forest":
        geo = sphere_forest(spec["n_spheres"], spec["subdiv"], spec["seed"])
        materials = spec["materials"]
    else:
        raise ValueError(f"unknown scene kind {spec['kind']!r}")
    p, n, uv = geo["positions"], geo["normals"], geo["uvs"]
    tri = np.concatenate([p.reshape(-1, 9), n.reshape(-1, 9), uv.reshape(-1, 6),
                          geo["mat_id"][:, None].astype(np.float32),
                          geo["obj_id"][:, None].astype(np.float32)], 1)
    tri = torch.as_tensor(tri, device=device)
    mats = material_table_arrays(materials)
    lights = np.asarray([pos for pos, _ in spec["lights"]], np.float32).reshape(-1, 3)
    radiance = np.asarray([rad for _, rad in spec["lights"]], np.float32).reshape(-1, 3)
    env32 = np.asarray(env_image, np.float32)
    image = torch.as_tensor(env32, device=device)
    cache = torch.as_tensor(env_cache_py(env32), device=device)
    tex_q = tex_normal = None
    if textures is not None:
        layers = np.stack([textures[k] for k in ("albedo", "metallic", "normal", "roughness")])
        tex = torch.as_tensor(layers[None], device=device)  # (1, 4, H, W, 3)
        combined = torch.cat([tex[:, 0], tex[:, 1, ..., :1], tex[:, 3, ..., :1]], dim=-1)
        tex_q = (combined * 255.0).to(torch.bfloat16)
        tex_normal = tex[:, 2].contiguous()
    return RefScene(
        tri=tri, clusters=Clusters(tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]),
        materials={k: torch.as_tensor(mats[f"materials.{k}"], device=device)
                   for k in MATERIAL_FIELDS},
        lights={"position": torch.as_tensor(lights, device=device),
                "radiance": torch.as_tensor(radiance, device=device)},
        env_image=image, env_nee_t=envmap.pack_env_nee_table(image, cache), env_cache=cache,
        tex_q=tex_q, tex_normal=tex_normal)

