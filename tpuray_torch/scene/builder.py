"""Scene assembly: OBJ files, materials, lights, textures and an env map ->
Scene (counterpart of tpuray/scene/builder.py, on the host; the OBJ
parser, the BVH builder and the env cache take the native library when it
loads, else their numpy versions, as the JAX package's do).

build_scene builds the flat arrays of scene_from_numpy with the JAX
package's steps and choices, and puts them on a device. The default scene is the original renderer's startup scene: clock.obj with a
textured material, 4 point lights and the procedural room env map
(reference_default_scene).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from tpuray_torch.accel.bvh import build_bvh
from tpuray_torch.io import native
from tpuray_torch.io.filesystem import resolve
from tpuray_torch.io.hdr import read_hdr
from tpuray_torch.io.image import read_image
from tpuray_torch.io.obj import load_obj, transform_matrix
from tpuray_torch.scene.host import env_cache_py, material_table_arrays, procedural_room_envmap
from tpuray_torch.scene.partition import apply_perm_padded, build_forest_bvh_uniform
from tpuray_torch.scene.types import MaterialTable, Scene, scene_from_numpy

# The JAX package's layout rule (tpuray/kernels/trace_pallas.py:630-635,
# scene_fits_smem): a scene whose single tree's scalar tables would not fit
# the TPU kernel's SMEM budget is built as a chunked forest. It is a TPU
# budget, and the Hopper kernels do not need it; the port keeps it so that
# both packages build the same scene from the same files.
SMEM_BUDGET_BYTES = 900_000


def fits_single_tree(n_nodes: int, n_tris: int) -> bool:
    """The layout rule: (11 * nodes + 12 * triangles) * 4 + 23 * 512 bytes
    below SMEM_BUDGET_BYTES keeps the single tree."""
    return (11 * int(n_nodes) + 12 * int(n_tris)) * 4 + 23 * 512 < SMEM_BUDGET_BYTES


@dataclasses.dataclass
class ObjectSpec:
    """One model instance: geometry, material and optional texture layers."""

    path: str  # resolved against the asset roots (io/filesystem.py)
    material: dict = dataclasses.field(default_factory=dict)
    rotate_deg: tuple = (0.0, 0.0, 0.0)
    translate: tuple = (0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)
    smooth_normals: bool = True
    # texture layers keyed albedo / metallic / normal / roughness: (H, W, 3)
    # float arrays, or image file paths (any io.image.read_image format)
    textures: dict = dataclasses.field(default_factory=dict)


def make_env_cache(image: np.ndarray) -> np.ndarray:
    """The env map's (sample_x, sample_y, pdf) cache: native, else numpy."""
    cache = native.env_cache_native(image)
    if cache is None:
        cache = env_cache_py(image)
    return cache


def make_material_table(materials: Sequence[dict], device="cpu") -> MaterialTable:
    """Material rows (defaults filled in) -> MaterialTable on `device`."""
    arrays = material_table_arrays(materials)
    return MaterialTable(**{k.split(".", 1)[1]: torch.from_numpy(v).to(device)
                            for k, v in arrays.items()})


def procedural_texture_layers(res: int = 256, seed: int = 7) -> dict:
    """Deterministic PBR texture layers (albedo, metallic, normal,
    roughness), stand-ins for the original renderer's BMP sets. `seed` is
    kept for the JAX package's signature; the layers do not depend on it."""
    del seed
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


def _load_texture_layer(layer) -> np.ndarray:
    """An (H, W, 3) float array, or an image path resolved against the asset
    roots and decoded by read_image."""
    if isinstance(layer, (str, bytes)):
        return read_image(resolve(layer))
    return np.asarray(layer, np.float32)


def _resize_nearest(img: np.ndarray, res: int) -> np.ndarray:
    img = np.asarray(img, np.float32)
    if img.shape[0] == res and img.shape[1] == res:
        return img
    yi = (np.arange(res) * img.shape[0] // res).clip(0, img.shape[0] - 1)
    xi = (np.arange(res) * img.shape[1] // res).clip(0, img.shape[1] - 1)
    return img[yi][:, xi]


def build_scene(objects: Sequence[ObjectSpec], point_lights: Sequence[tuple] = (),
                envmap: np.ndarray | str | None = None, leaf_size: int = 8,
                texture_res: int = 256, reference_quirks: bool = False,
                with_textures: bool = False, max_chunk_tris: int = 2048,
                device="cpu") -> Scene:
    """The JAX package's build_scene, on `device`: load and transform each
    OBJ (object i gets material and object id i), build the single tree, or
    a uniform chunked forest when the tree breaks the layout rule
    (fits_single_tree), the material table, the texture stack (procedural
    layers where an object gives none) and the env map (a procedural room,
    a Radiance file or an array) with its sampling cache."""
    all_p, all_n, all_uv, all_mat, all_obj = [], [], [], [], []
    materials, tex_layers = [], []
    for i, spec in enumerate(objects):
        tm = transform_matrix(spec.rotate_deg, spec.translate, spec.scale)
        geo = load_obj(resolve(spec.path), tm, spec.smooth_normals,
                       reference_quirks=reference_quirks)
        t = geo["positions"].shape[0]
        all_p.append(geo["positions"])
        all_n.append(geo["normals"])
        all_uv.append(geo["uvs"])
        all_mat.append(np.full((t,), i, np.int32))
        all_obj.append(np.full((t,), i, np.int32))
        materials.append(spec.material)
        if with_textures:
            layers = spec.textures or procedural_texture_layers(texture_res, seed=7 + i)
            layers = {k: _load_texture_layer(v) for k, v in layers.items()}
            tex_layers.append(np.stack([
                _resize_nearest(layers[k], texture_res)
                for k in ("albedo", "metallic", "normal", "roughness")]))

    pos = np.concatenate(all_p)
    nrm = np.concatenate(all_n)
    uv = np.concatenate(all_uv)
    mat_id = np.concatenate(all_mat)
    obj_id = np.concatenate(all_obj)

    arrays = {}
    # the single tree first: the rule is on its real node count
    bvh = build_bvh(pos, leaf_size)
    perm = bvh["perm"]
    if not fits_single_tree(len(bvh["skip"]), len(pos)):
        bvh = build_forest_bvh_uniform(pos, leaf_size, max_chunk_tris)
        pos, nrm, uv, mat_id, obj_id = (apply_perm_padded(a, bvh["perm"])
                                        for a in (pos, nrm, uv, mat_id, obj_id))
        perm = np.arange(len(pos))  # the attributes are permuted and padded
        arrays["bvh.chunk_nodes"] = np.asarray(bvh["chunk_nodes"])
        arrays["bvh.chunk_tris"] = np.asarray(bvh["chunk_tris"])
    for k in range(3):
        arrays[f"triangles.p{k}"] = pos[perm, k]
        arrays[f"triangles.n{k}"] = nrm[perm, k]
        arrays[f"triangles.uv{k}"] = uv[perm, k]
    arrays["triangles.mat_id"] = mat_id[perm]
    arrays["triangles.obj_id"] = obj_id[perm]
    for key in ("aabb_min", "aabb_max", "first_tri", "tri_count", "skip"):
        arrays[f"bvh.{key}"] = bvh[key]
    arrays.update(material_table_arrays(materials))

    arrays["lights.position"] = np.asarray(
        [p for p, _ in point_lights], np.float32).reshape(-1, 3)
    arrays["lights.radiance"] = np.asarray(
        [r for _, r in point_lights], np.float32).reshape(-1, 3)

    if envmap is None:
        env_img = procedural_room_envmap()
    elif isinstance(envmap, str):
        env_img = read_hdr(envmap)
    else:
        env_img = np.asarray(envmap, np.float32)
    arrays["envmap.image"] = env_img
    arrays["envmap.cache"] = make_env_cache(env_img)
    if tex_layers:
        arrays["textures.data"] = np.stack(tex_layers)
    return scene_from_numpy(arrays, device)


# the original renderer's startup material and lights
DEFAULT_MATERIAL = dict(base_color=(-1.0, -1.0, -1.0), metallic=-1.0, roughness=-1.0,
                        specular=0.0, clearcoat=0.0, clearcoat_gloss=0.0)
DEFAULT_LIGHTS = (
    ((0.5, 0.5, 0.5), (10.0, 10.0, 10.0)),
    ((-0.5, 0.75, 0.5), (8.0, 4.0, 4.0)),
    ((-0.5, 0.75, 0.75), (0.0, 3.0, 4.0)),
    ((0.75, 0.75, 0.75), (12.0, 3.0, 4.0)),
)


def reference_default_scene(reference_obj_dir: str | None = None, **kw) -> Scene:
    """The original renderer's startup scene: clock.obj (specular 0,
    clearcoat 0, base color, metallic and roughness from the textures: the
    -1 sentinels), 4 point lights and the room env map. models/clock.obj
    resolves against the asset roots unless reference_obj_dir pins a
    directory; kw goes to build_scene (with_textures defaults to True)."""
    clock = ObjectSpec(
        path=(f"{reference_obj_dir}/clock.obj" if reference_obj_dir
              else "models/clock.obj"),
        material=dict(DEFAULT_MATERIAL))
    kw.setdefault("with_textures", True)
    return build_scene([clock], point_lights=DEFAULT_LIGHTS, **kw)
