"""OBJ loading: parse (native, else numpy), then process the geometry
(counterpart of tpuray/io/obj.py).

The processing is the original loader's pipeline:
  1. normalise the model into a unit box (divide by the largest AABB extent);
  2. apply a TRS model transform;
  3. smooth vertex normals from the accumulated unit facet normals;
  4. emit per-triangle position, normal and uv arrays.

reference_quirks=True replicates the original loader's bound bug (its y
and z bounds reuse the running x bound), as the JAX package does.
"""
from __future__ import annotations

import math

import numpy as np

from tpuray_torch.io import native
from tpuray_torch.io.fallback import parse_obj_py


def parse_obj(path: str):
    """-> (positions, texcoords, face_v, face_vt): io/native.py's parser
    when the library loads, else the numpy one."""
    out = native.parse_obj_native(path)
    if out is None:
        out = parse_obj_py(path)
    return out


def transform_matrix(rotate_deg=(0, 0, 0), translate=(0, 0, 0), scale=(1, 1, 1)) -> np.ndarray:
    """model = T * Rx * Ry * Rz * S (4x4 float64)."""
    rx, ry, rz = (math.radians(a) for a in rotate_deg)

    def rot(axis, a):
        c, s = math.cos(a), math.sin(a)
        m = np.eye(4)
        if axis == 0:
            m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
        elif axis == 1:
            m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
        else:
            m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
        return m

    t = np.eye(4)
    t[:3, 3] = translate
    s = np.diag([scale[0], scale[1], scale[2], 1.0])
    return t @ rot(0, rx) @ rot(1, ry) @ rot(2, rz) @ s


def load_obj(path: str, transform: np.ndarray | None = None,
             smooth_normals: bool = True, normalize: bool = True,
             reference_quirks: bool = False) -> dict:
    """-> {"positions": (T, 3, 3), "normals": (T, 3, 3), "uvs": (T, 3, 2)},
    float32, one row per triangle."""
    pos, uv, fv, fvt = parse_obj(path)
    pos = pos.astype(np.float64)

    if normalize and len(pos):
        if reference_quirks:
            maxx = maxy = maxz = -11451419.19
            minx = miny = minz = 11451419.19
            for x, y, z in pos:
                maxx = max(maxx, x); maxy = max(maxx, y); maxz = max(maxx, z)  # noqa: E702
                minx = min(minx, x); miny = min(minx, y); minz = min(minx, z)  # noqa: E702
            extent = max(maxx - minx, maxy - miny, maxz - minz)
        else:
            extent = float((pos.max(axis=0) - pos.min(axis=0)).max())
        pos = pos / extent

    if transform is not None:
        pos = pos @ np.asarray(transform)[:3, :3].T + np.asarray(transform)[:3, 3]

    tri_p = pos[fv]  # (T, 3, 3)

    # unit facet normals, accumulated per vertex, then normalised
    e1 = tri_p[:, 1] - tri_p[:, 0]
    e2 = tri_p[:, 2] - tri_p[:, 0]
    fn = np.cross(e1, e2)
    fn_len = np.linalg.norm(fn, axis=-1, keepdims=True)
    fn_unit = fn / np.maximum(fn_len, 1e-30)

    if smooth_normals:
        vn = np.zeros_like(pos)
        np.add.at(vn, fv[:, 0], fn_unit)
        np.add.at(vn, fv[:, 1], fn_unit)
        np.add.at(vn, fv[:, 2], fn_unit)
        vn = vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-30)
        tri_n = vn[fv]
    else:
        tri_n = np.repeat(fn_unit[:, None, :], 3, axis=1)

    if len(uv):
        safe_vt = np.where(fvt >= 0, fvt, 0)
        tri_uv = uv[safe_vt].astype(np.float32)
    else:
        tri_uv = np.zeros((len(fv), 3, 2), np.float32)

    return dict(positions=tri_p.astype(np.float32),
                normals=tri_n.astype(np.float32), uvs=tri_uv)


def write_obj(path: str, positions: np.ndarray, faces: np.ndarray,
              texcoords: np.ndarray | None = None,
              face_texcoords: np.ndarray | None = None) -> None:
    """Write triangles as an OBJ: `v` rows (V, 3), optional `vt` rows
    (VT, 2), and `f` rows of 0-based (F, 3) vertex ids, with texcoord ids
    (F, 3) when given."""
    lines = [f"v {x!r} {y!r} {z!r}"
             for x, y, z in np.asarray(positions, np.float64).tolist()]
    if texcoords is not None:
        lines += [f"vt {u!r} {v!r}" for u, v in np.asarray(texcoords, np.float64).tolist()]
    faces = np.asarray(faces, np.int64).tolist()
    if face_texcoords is None:
        lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in faces]
    else:
        ft = np.asarray(face_texcoords, np.int64).tolist()
        lines += [f"f {a + 1}/{ta + 1} {b + 1}/{tb + 1} {c + 1}/{tc + 1}"
                  for (a, b, c), (ta, tb, tc) in zip(faces, ft)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
