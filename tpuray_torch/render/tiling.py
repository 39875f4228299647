"""Tile-major ray ordering (counterpart of tpuray/render/tiling.py).

Rays are generated in 32x32-image-tile order and frame buffers un-tiled
with one reshape/transpose, exactly as the JAX package does, so per-ray
outputs line up between the two packages.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from tpuray_torch.scene.types import Camera

Tensor = torch.Tensor
TILE = 32


def padded_size(x: int) -> int:
    return (x + TILE - 1) // TILE * TILE


def tile_pixel_coords(height: int, width: int, device="cpu"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,) int32 x/y pixel coords in tile-major order (padded image)."""
    hp, wp = padded_size(height), padded_size(width)
    ty, tx, iy, ix = torch.meshgrid(
        torch.arange(hp // TILE, device=device),
        torch.arange(wp // TILE, device=device),
        torch.arange(TILE, device=device),
        torch.arange(TILE, device=device), indexing="ij")
    xx = (tx * TILE + ix).reshape(-1)
    yy = (ty * TILE + iy).reshape(-1)
    return xx.to(torch.int32), yy.to(torch.int32)


def untile(flat: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(N, ...) tile-major -> (H, W, ...) image (cropping padding), in
    memory of its own: the per-ray buffer may be a replayed CUDA graph's
    output, which the next frame overwrites."""
    hp, wp = padded_size(height), padded_size(width)
    rest = flat.shape[1:]
    img = flat.reshape(hp // TILE, wp // TILE, TILE, TILE, *rest)
    img = torch.movedim(img, 2, 1).reshape(hp, wp, *rest)
    if img.data_ptr() == flat.data_ptr():  # one tile column: a view
        img = img.clone()
    return img[:height, :width]


def camera_rays(camera: Camera, height: int, width: int
                ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Primary rays in 32x32-tile order -> (orig (N, 3) view, d (N, 3),
    px, py). px/py are GL frag coords (bottom-up), padding rows included."""
    return pixel_rays(camera, height, width,
                      *tile_pixel_coords(height, width, camera.eye.device))


def pixel_rays(camera: Camera, height: int, width: int, xx: Tensor, yy: Tensor
               ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The primary rays of pixels (xx, yy) (int32, row 0 the top row), in
    their order -> (orig (N, 3) view, d (N, 3), px, py)."""
    d = camera.pixel_directions(height, width, xx, yy)
    orig = camera.eye.expand(xx.shape[0], 3)
    return orig, d, xx, height - 1 - yy
