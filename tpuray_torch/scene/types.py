"""Scene model as dataclasses of torch tensors (flat SoA arrays).

Counterpart of tpuray/scene/types.py: the same classes and fields, held as
plain dataclasses instead of flax pytrees. Every class has `.to(device)`
and `.replace(**fields)` (flax's `replace`).
The scene is this system's "weights": `scene_from_numpy` carries a scene
built by either package (flattened to numpy by `scene_to_numpy`) onto a
device, so both packages can render the same tree.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor


def _to(obj, device):
    """Copy of a dataclass with every tensor field moved to `device`."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v):
            v = v.to(device)
        kw[f.name] = v
    return dataclasses.replace(obj, **kw)


class _Fields:
    """`.to(device)` and `.replace(**fields)` for the dataclasses below."""

    def to(self, device):
        return _to(self, device)

    def replace(self, **fields):
        return dataclasses.replace(self, **fields)


@dataclasses.dataclass
class MaterialTable(_Fields):
    """Disney BSDF parameter table, one row per material. Negative
    base_color / metallic / roughness mean "fetch from the texture stack"."""

    emissive: Tensor       # (M, 3) f32
    base_color: Tensor     # (M, 3) f32
    subsurface: Tensor     # (M,) f32
    metallic: Tensor
    specular: Tensor
    specular_tint: Tensor
    roughness: Tensor
    anisotropic: Tensor
    sheen: Tensor
    sheen_tint: Tensor
    clearcoat: Tensor
    clearcoat_gloss: Tensor
    ior: Tensor
    transmission: Tensor

    @property
    def count(self) -> int:
        return self.subsurface.shape[0]


@dataclasses.dataclass
class TriangleSoA(_Fields):
    """Triangle geometry, SoA, in BVH leaf order."""

    p0: Tensor      # (T, 3) f32
    p1: Tensor
    p2: Tensor
    n0: Tensor      # (T, 3) f32 vertex normals
    n1: Tensor
    n2: Tensor
    uv0: Tensor     # (T, 2) f32
    uv1: Tensor
    uv2: Tensor
    mat_id: Tensor  # (T,) int32
    obj_id: Tensor  # (T,) int32

    @property
    def count(self) -> int:
        return self.p0.shape[0]


@dataclasses.dataclass
class BVHSoA(_Fields):
    """Threaded BVH in DFS preorder with skip links (see the JAX package's
    BVHSoA): next = node + 1 on an inner-node hit, skip[node] otherwise.
    chunk_nodes/chunk_tris > 0 marks a chunked forest."""

    aabb_min: Tensor   # (N, 3) f32
    aabb_max: Tensor   # (N, 3) f32
    first_tri: Tensor  # (N,) int32
    tri_count: Tensor  # (N,) int32 (0 => inner node)
    skip: Tensor       # (N,) int32
    chunk_nodes: int = 0
    chunk_tris: int = 0

    @property
    def count(self) -> int:
        return self.aabb_min.shape[0]


@dataclasses.dataclass
class PointLights(_Fields):
    position: Tensor  # (L, 3) f32
    radiance: Tensor  # (L, 3) f32

    @property
    def count(self) -> int:
        return self.position.shape[0]


@dataclasses.dataclass
class EnvMap(_Fields):
    """Equirectangular HDR image + (inv_cdf_x, inv_cdf_y, pdf) cache."""

    image: Tensor  # (H, W, 3) f32
    cache: Tensor  # (H, W, 3) f32


@dataclasses.dataclass
class TextureStack(_Fields):
    """Per-object PBR texture stack: 4 layers per object (albedo, metallic,
    normal, roughness)."""

    data: Tensor  # (n_objects, 4, H, W, 3) f32 in [0, 1]

    @property
    def n_objects(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass
class Scene(_Fields):
    triangles: TriangleSoA
    bvh: BVHSoA
    materials: MaterialTable
    lights: PointLights
    envmap: EnvMap
    textures: Optional[TextureStack] = None


@dataclasses.dataclass
class Camera(_Fields):
    """Pinhole camera: primary dir = cam_to_world @ (px, py, -1)."""

    eye: Tensor           # (3,) f32
    cam_to_world: Tensor  # (3, 3) f32
    view_proj: Tensor     # (4, 4) f32
    tan_half_fov: Tensor  # () f32

    def ray_directions(self, height: int, width: int) -> Tensor:
        """(H, W, 3) normalized world-space primary directions, row-major
        with row 0 the top image row (tpuray/scene/types.py:210-222)."""
        dev = self.eye.device
        yy, xx = torch.meshgrid(torch.arange(height, device=dev),
                                torch.arange(width, device=dev), indexing="ij")
        return self.pixel_directions(height, width, xx, yy)

    def pixel_directions(self, height: int, width: int, xx: Tensor, yy: Tensor
                         ) -> Tensor:
        """(..., 3) normalized primary directions of the pixels (xx, yy)
        (integer, row 0 the top image row): every primary ray of the port,
        whatever the pixel order."""
        th = self.tan_half_fov
        xs = (2.0 * (xx.to(torch.float32) + 0.5) / width - 1.0) * th
        ys = -((2.0 * (yy.to(torch.float32) + 0.5) / height - 1.0) * th)
        c = self.cam_to_world
        # cam_to_world @ (xs, ys, -1), written out elementwise
        d = torch.stack([c[i, 0] * xs + c[i, 1] * ys + c[i, 2] * -1.0
                         for i in range(3)], dim=-1)
        return d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))


_GROUPS = {
    "triangles": TriangleSoA, "bvh": BVHSoA, "materials": MaterialTable,
    "lights": PointLights, "envmap": EnvMap,
}
_INT_FIELDS = {"mat_id", "obj_id", "first_tri", "tri_count", "skip"}


def scene_to_numpy(scene) -> dict[str, np.ndarray]:
    """Flatten a Scene of either package to {"group.field": ndarray}."""
    out = {}
    for group in list(_GROUPS) + ["textures"]:
        part = getattr(scene, group)
        if part is None:
            continue
        for f in dataclasses.fields(part):
            v = getattr(part, f.name)
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            out[f"{group}.{f.name}"] = np.asarray(v)
    return out


def scene_from_numpy(arrays: dict[str, np.ndarray], device="cpu") -> Scene:
    """Build a torch Scene on `device` from `scene_to_numpy`-style arrays.

    A chunked forest's chunk_nodes / chunk_tris (0-d arrays, absent for a
    single tree) become ints; "textures.data", where present, becomes the
    scene's TextureStack."""
    parts = {}
    for group, cls in _GROUPS.items():
        kw = {}
        for f in dataclasses.fields(cls):
            key = f"{group}.{f.name}"
            if f.name in ("chunk_nodes", "chunk_tris"):
                kw[f.name] = int(arrays.get(key, 0))
                continue
            dt = np.int32 if f.name in _INT_FIELDS else np.float32
            a = np.array(arrays[key], dtype=dt)  # a writable copy
            kw[f.name] = torch.from_numpy(a).to(device)
        parts[group] = cls(**kw)
    if "textures.data" in arrays:
        data = np.array(arrays["textures.data"], dtype=np.float32)
        parts["textures"] = TextureStack(data=torch.from_numpy(data).to(device))
    return Scene(**parts)
