"""Shading-time table lookups (counterpart of
tpuray/integrator/gather_tables.py).

What the JAX tables compute, as plain row indexing: one (T, 26) row per
triangle [p0 p1 p2 | n0 n1 n2 | uv0 uv1 uv2 | mat_id obj_id], one (M, 18)
row per material, one (L, 6) row per point light, and the env-map NEE
table. The TPU layouts (select chains, quad packing, bf16 texture stacks)
are not needed on the card.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from tpuray_torch.integrator.disney import ShadeMaterial
from tpuray_torch.sampling.envmap import pack_env_nee_table

Tensor = torch.Tensor


class TriAttrs(NamedTuple):
    p0: Tensor
    p1: Tensor
    p2: Tensor
    n0: Tensor
    n1: Tensor
    n2: Tensor
    uv0: Tensor
    uv1: Tensor
    uv2: Tensor
    mat_id: Tensor
    obj_id: Tensor


# a table of at most this many rows gathers with a one-hot backward (the
# JAX package's fetch_small_table bound)
SMALL_TABLE_ROWS = 64


class _SmallTableRows(torch.autograd.Function):
    """table[idx] whose backward sums each row's gradient with a one-hot
    matmul. PyTorch's index backward serialises repeated indices: a
    2-material table fetched at 640k hits took 0.46 s of a 0.52 s train
    step at 800x800 on an H100 (PERF.md)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        onehot = torch.nn.functional.one_hot(idx, ctx.n_rows).to(grad.dtype)
        return onehot.T @ grad, None


def fetch_rows(table: Tensor, idx: Tensor) -> Tensor:
    """table[idx] for an (M, W) table and (N,) int64 indices. While autograd
    records a small table, its backward is a one-hot matmul, which the
    JAX package's select-chain fetch also reduces to."""
    if (table.requires_grad and torch.is_grad_enabled()
            and table.shape[0] <= SMALL_TABLE_ROWS):
        return _SmallTableRows.apply(table, idx)
    return table[idx]


def pack_tri_table(tri) -> Tensor:
    return torch.cat([tri.p0, tri.p1, tri.p2, tri.n0, tri.n1, tri.n2,
                      tri.uv0, tri.uv1, tri.uv2,
                      tri.mat_id[:, None].to(torch.float32),
                      tri.obj_id[:, None].to(torch.float32)], dim=-1)


def fetch_tri(table: Tensor, idx: Tensor) -> TriAttrs:
    row = table[idx.long()]
    return TriAttrs(
        p0=row[..., 0:3], p1=row[..., 3:6], p2=row[..., 6:9],
        n0=row[..., 9:12], n1=row[..., 12:15], n2=row[..., 15:18],
        uv0=row[..., 18:20], uv1=row[..., 20:22], uv2=row[..., 22:24],
        mat_id=row[..., 24].to(torch.int64), obj_id=row[..., 25].to(torch.int64))


def pack_material_table(m) -> Tensor:
    """MaterialTable -> (M, 18) rows."""
    return torch.cat([
        m.emissive, m.base_color,
        m.subsurface[:, None], m.metallic[:, None], m.specular[:, None],
        m.specular_tint[:, None], m.roughness[:, None], m.anisotropic[:, None],
        m.sheen[:, None], m.sheen_tint[:, None], m.clearcoat[:, None],
        m.clearcoat_gloss[:, None], m.ior[:, None], m.transmission[:, None],
    ], dim=-1)


def fetch_material(table: Tensor, mat_id: Tensor) -> ShadeMaterial:
    row = fetch_rows(table, mat_id)
    return ShadeMaterial(
        emissive=row[..., 0:3], base_color=row[..., 3:6],
        subsurface=row[..., 6], metallic=row[..., 7], specular=row[..., 8],
        specular_tint=row[..., 9], roughness=row[..., 10],
        sheen=row[..., 12], sheen_tint=row[..., 13], clearcoat=row[..., 14],
        clearcoat_gloss=row[..., 15], anisotropic=row[..., 11],
    )


def pack_lights(lights) -> Tensor:
    """PointLights -> (L, 6) rows [position, radiance]."""
    return torch.cat([lights.position, lights.radiance], dim=-1)


@dataclasses.dataclass(frozen=True)
class PackedScene:
    """Shading tables, built once per scene."""

    tri_table: Tensor    # (T, 26)
    mat_table: Tensor    # (M, 18)
    light_table: Tensor  # (L, 6)
    env_image: Tensor    # (H, W, 3)
    env_cache: Tensor    # (H, W, 3) [inv_cdf_x, inv_cdf_y, pdf] (MIS)
    env_nee_t: Tensor    # (H, W, 8) [L, radiance, pdf, 0]


def pack_scene_tables(scene) -> PackedScene:
    if scene.textures is not None:
        raise NotImplementedError(
            "scenes with textures are not ported yet (ROADMAP.md item 9)")
    return PackedScene(
        tri_table=pack_tri_table(scene.triangles),
        mat_table=pack_material_table(scene.materials),
        light_table=pack_lights(scene.lights),
        env_image=scene.envmap.image,
        env_cache=scene.envmap.cache,
        env_nee_t=pack_env_nee_table(scene.envmap.image, scene.envmap.cache),
    )
