"""Tile-major ray ordering (counterpart of tpuray/render/tiling.py).

Rays are generated in 32x32-image-tile order and frame buffers un-tiled
with one reshape/transpose, exactly as the JAX package does, so per-ray
outputs line up between the two packages.
"""
from __future__ import annotations

import torch

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
    """(N, ...) tile-major -> (H, W, ...) image (cropping padding)."""
    hp, wp = padded_size(height), padded_size(width)
    rest = flat.shape[1:]
    img = flat.reshape(hp // TILE, wp // TILE, TILE, TILE, *rest)
    img = torch.movedim(img, 2, 1).reshape(hp, wp, *rest)
    return img[:height, :width]
