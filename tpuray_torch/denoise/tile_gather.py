"""The tile-windowed history read (counterpart of tpuray/denoise/tile_gather.py).

tpuray fetches the history by tiles: each (ty, tx) tile DMAs one window
of the atlas whose base is the least diagonal residual r = clip(y0) - y
over the tile and a halo, and selects each pixel's base texel inside the
window by its residual; a neighbour tap (dy, dx) is the neighbour pixel's
selected texel. That machinery is the TPU's answer to slow gathers and is
not ported. What it computes is: a tap resolves where

  - the neighbour pixel's residual lies in the window: r - o in [0, span]
    in both axes, o the tile's window offset (the least residual, clipped
    with the window base);
  - the neighbour's residual equals the pixel's own (the diagonal
    identity: the neighbour's texel is the pixel's base + (dy, dx));
  - that texel lies inside the image.

Where a tap resolves its value is atlas[clip(y0) + dy, clip(x0) + dx],
the exact read; elsewhere it is the neighbour's selected texel where the
neighbour lies in the window (zero past the image), else zero, which a
caller reads only for the history length. This module computes exactly
that, per pixel, with a GPU's direct reads.

The window offsets: tpuray takes the min over each tile extended by a
halo of 1 (reduce_window), of the residuals of the pixels whose base lies
within one texel of the image, and clips the window base to [-wy, h]
(the guard pad). The TPU kernel K4 (kernels/reproject.py) takes a halo of
4 and clips to [-PY, hp]; both are parameters here.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

# tolerated per-tile variation of the integer motion (pixels)
DEFAULT_SPAN = 4
DEFAULT_TY = 40
DEFAULT_TX = 160

QUAD = ((0, 0), (1, 0), (0, 1), (1, 1))
BIG = 2 ** 30  # the window minimum's sentinel


def halo_min(f: Tensor, ty: int, tx: int, halo: int) -> Tensor:
    """(h, w) int32 -> (ceil(h / ty), ceil(w / tx)): the min over each tile
    extended by `halo` on every side, of its part inside the image
    (reduce_window(min) with window t + 2 * halo and stride t)."""
    h, w = f.shape
    nty, ntx = -(-h // ty), -(-w // tx)
    g = torch.full((nty * ty + 2 * halo, ntx * tx + 2 * halo), BIG, dtype=torch.int32,
                   device=f.device)
    g[halo:halo + h, halo:halo + w] = f
    win = g.unfold(0, ty + 2 * halo, ty).unfold(1, tx + 2 * halo, tx)
    return win.amin(dim=(-2, -1))


def window_offsets(y0: Tensor, x0: Tensor, ty: int, tx: int, halo: int,
                   clip_y: tuple[int, int], clip_x: tuple[int, int]
                   ) -> tuple[Tensor, Tensor]:
    """Each tile's window offsets (oy, ox), (nty, ntx) int32: the window
    base minus the tile's origin less the halo. y0, x0: (h, w) unclipped
    base taps; clip_y, clip_x: the window base's bounds."""
    h, w = y0.shape
    dev = y0.device
    y0, x0 = y0.to(torch.int32), x0.to(torch.int32)
    yy = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    # a pixel whose every tap lies off the image does not move the window
    relevant = (y0 >= -1) & (y0 <= h) & (x0 >= -1) & (x0 <= w)
    rg = torch.where(relevant, torch.clamp(y0, 0, h - 1) - yy, BIG)
    cg = torch.where(relevant, torch.clamp(x0, 0, w - 1) - xx, BIG)
    gy = torch.arange(0, h, ty, dtype=torch.int32, device=dev)[:, None]
    gx = torch.arange(0, w, tx, dtype=torch.int32, device=dev)[None, :]
    by = torch.clamp(halo_min(rg, ty, tx, halo) + gy - halo, *clip_y)
    bx = torch.clamp(halo_min(cg, ty, tx, halo) + gx - halo, *clip_x)
    return by - gy + halo, bx - gx + halo


def resolve(rg: Tensor, cg: Tensor, yy: Tensor, xx: Tensor, h: int, w: int,
            oy: Tensor, ox: Tensor, offsets, span: int) -> dict:
    """The resolution of each tap, per pixel.

    rg, cg: (..., R + 2, C + 2) the clipped diagonal residuals of a grid of
    pixels with a one-pixel margin (how the margin extends past the image
    is the caller's: tile_gather clips and then shifts, K4 shifts and then
    clips); yy, xx: the rows and columns of the R x C inner pixels,
    broadcastable; oy, ox: each inner pixel's window offsets; h, w: the
    image. -> {(dy, dx): (resolved, in_window, row, col)}: the tap's
    texel is (row, col), which the neighbour selects where in_window."""
    r, c = rg.shape[-2] - 2, rg.shape[-1] - 2
    rc, cc = rg[..., 1:r + 1, 1:c + 1], cg[..., 1:r + 1, 1:c + 1]
    out = {}
    for dy, dx in offsets:
        rq = rg[..., 1 + dy:1 + dy + r, 1 + dx:1 + dx + c]
        cq = cg[..., 1 + dy:1 + dy + r, 1 + dx:1 + dx + c]
        sel = (rq >= oy) & (rq <= oy + span) & (cq >= ox) & (cq <= ox + span)
        ty_, tx_ = rq + (yy + dy), cq + (xx + dx)
        ok = (sel & (rq == rc) & (cq == cc)
              & (ty_ >= 0) & (ty_ < h) & (tx_ >= 0) & (tx_ < w))
        out[(dy, dx)] = (ok, sel, ty_, tx_)
    return out


def fetch(atlas: Tensor, sel: Tensor, ty_: Tensor, tx_: Tensor) -> Tensor:
    """atlas[ty_, tx_] where sel and inside the image, else zero."""
    h, w = atlas.shape[:2]
    inside = sel & (ty_ >= 0) & (ty_ < h) & (tx_ >= 0) & (tx_ < w)
    j = (torch.clamp(ty_, 0, h - 1) * w + torch.clamp(tx_, 0, w - 1)).reshape(-1)
    v = atlas.reshape(h * w, -1)[j].reshape(*ty_.shape, -1)
    return torch.where(inside[..., None], v, 0.0).reshape(*ty_.shape, *atlas.shape[2:])


def edge_residuals(y0: Tensor, x0: Tensor) -> tuple[Tensor, Tensor]:
    """tile_gather's residual grid with its margin: the clipped residual of
    the nearest image pixel (the residuals edge-padded by one)."""
    h, w = y0.shape
    dev = y0.device
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    rg = torch.clamp(y0, 0, h - 1) - yy
    cg = torch.clamp(x0, 0, w - 1) - xx
    iy = torch.clamp(torch.arange(-1, h + 1, device=dev), 0, h - 1)
    ix = torch.clamp(torch.arange(-1, w + 1, device=dev), 0, w - 1)
    return rg[iy][:, ix], cg[iy][:, ix]


def tiled_taps(atlas: Tensor, y0: Tensor, x0: Tensor, offsets,
               span: int = DEFAULT_SPAN, ty: int = DEFAULT_TY, tx: int = DEFAULT_TX,
               halo: int = 1, clip_y: tuple[int, int] | None = None,
               clip_x: tuple[int, int] | None = None) -> tuple[dict, dict]:
    """atlas[clip(y0) + dy, clip(x0) + dx] for every (dy, dx) in offsets,
    with tpuray's exactness masks.

    atlas: (H, W, C); y0, x0: (H, W) integer base taps (unclipped).
    Offsets lie in {-1, 0, 1}^2. clip_y, clip_x default to tile_gather's
    window-base bounds, [-wy, H] and [-wx, W]. -> (taps, resolved): dicts
    keyed by offset of (H, W, C) values and (H, W) bool masks."""
    h, w = y0.shape
    assert all(-1 <= dy <= 1 and -1 <= dx <= 1 for dy, dx in offsets)
    if clip_y is None:
        clip_y = (-(ty + span + 2), h)
    if clip_x is None:
        clip_x = (-(tx + span + 2), w)
    oy, ox = window_offsets(y0, x0, ty, tx, halo, clip_y, clip_x)
    dev = y0.device
    iy = torch.arange(h, device=dev)[:, None]
    ix = torch.arange(w, device=dev)[None, :]
    oy, ox = oy[iy // ty, ix // tx], ox[iy // ty, ix // tx]
    rg, cg = edge_residuals(y0, x0)
    res = resolve(rg, cg, iy, ix, h, w, oy, ox, offsets, span)
    taps = {e: fetch(atlas, sel, ty_, tx_) for e, (_, sel, ty_, tx_) in res.items()}
    return taps, {e: r[0] for e, r in res.items()}
