"""The port's tile-windowed history read (tpuray_torch/denoise/tile_gather.py)
against tpuray's (tpuray/denoise/tile_gather.py), on the CPU.

- tiled_taps on the six cases of tests/test_tile_gather.py, at that file's
  span 6 and tile shapes, and on one case at a span and tile of neither
  default: the resolved masks bit-equal to tpuray's, and the taps equal to
  them wherever a tap resolves (the exactness contract: the exact read),
  and everywhere else too (the texel the neighbour selects, or zero; the
  reprojection reads an unresolved corner's history length);
- the window offsets' halo and clip bounds as parameters: a halo of 4 moves
  the resolution where the tiles meet, as the TPU kernel's wider minimum does;
- the history atlas: tpuray's build_atlas layout and split's channels;
- TAA's tile-windowed history fetch (taa(tiled_fetch=True)) against
  tpuray's, on the whole image and on a halo-extended row slab with the
  row window: rtol 1e-5 / atol 1e-6.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuray.denoise import taa as jtaa
from tpuray.denoise.tile_gather import QUAD, tiled_taps as j_tiled_taps

from tpuray_torch.denoise import taa
from tpuray_torch.denoise import tile_gather

from tests.test_torch_denoise import _motion, gbuffer_arrays
from tests.test_torch_denoise_tiles import _slab

torch.set_num_threads(2)

OFFS = tuple(sorted(set((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)) | set(QUAD)))


def _grids(h, w):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return yy.astype(np.float32), xx.astype(np.float32)


def _case(name):
    """(atlas, y0, x0, span, ty, tx) of tests/test_tile_gather.py's case."""
    if name == "smooth":
        h = w = 200
        rng = np.random.default_rng(0)
        atlas = rng.random((h, w, 5), np.float32)
        yy, xx = _grids(h, w)
        y0 = np.floor(yy - 3.2 + 1.5 * np.sin(xx / 37.0)).astype(np.int32)
        x0 = np.floor(xx + 4.7 + 2.0 * np.cos(yy / 53.0)).astype(np.int32)
        return atlas, y0, x0, 6, 40, 100
    if name == "static":
        h, w = 120, 240
        rng = np.random.default_rng(1)
        atlas = rng.random((h, w, 3), np.float32)
        yy, xx = _grids(h, w)
        return atlas, yy.astype(np.int32), xx.astype(np.int32), 4, 40, 120
    if name in ("discontinuous", "discontinuous_span3"):
        h = w = 160
        rng = np.random.default_rng(2)
        atlas = rng.random((h, w, 4), np.float32)
        yy, xx = _grids(h, w)
        jump = (xx > w // 2).astype(np.float32)
        y0 = (yy - 20.0 * jump).astype(np.int32)
        x0 = (xx + 11.0 * jump).astype(np.int32)
        if name == "discontinuous_span3":  # a span and a tile of neither default
            return atlas, y0, x0, 3, 24, 56
        return atlas, y0, x0, 6, 40, 80
    if name == "wild":
        h = w = 160
        rng = np.random.default_rng(3)
        atlas = rng.random((h, w, 2), np.float32)
        y0 = rng.integers(-50, h + 50, (h, w), dtype=np.int32)
        x0 = rng.integers(-50, w + 50, (h, w), dtype=np.int32)
        return atlas, y0, x0, 6, 40, 80
    if name == "non_divisible":
        h, w = 173, 241
        rng = np.random.default_rng(4)
        atlas = rng.random((h, w, 3), np.float32)
        yy, xx = _grids(h, w)
        y0 = np.floor(yy - 1.3 + 0.8 * np.sin(xx / 29.0)).astype(np.int32)
        x0 = np.floor(xx + 2.1).astype(np.int32)
        return atlas, y0, x0, 6, 40, 80
    if name == "uniform_large_shift":
        h = w = 160
        rng = np.random.default_rng(5)
        atlas = rng.random((h, w, 3), np.float32)
        yy, xx = _grids(h, w)
        return atlas, (yy - 57).astype(np.int32), (xx + 43).astype(np.int32), 6, 40, 80
    raise ValueError(name)


CASES = ["smooth", "static", "discontinuous", "wild", "non_divisible",
         "uniform_large_shift", "discontinuous_span3"]


@pytest.mark.parametrize("name", CASES)
def test_tiled_taps_match_tpuray(name):
    atlas, y0, x0, span, ty, tx = _case(name)
    offs = ((0, 0),) if name == "static" else OFFS
    ref_taps, ref_res = j_tiled_taps(atlas, y0, x0, offs, span=span, ty=ty, tx=tx)
    taps, res = tile_gather.tiled_taps(torch.from_numpy(atlas), torch.from_numpy(y0),
                                       torch.from_numpy(x0), offs, span=span, ty=ty, tx=tx)
    h, w = y0.shape
    for e in offs:
        ok = res[e].numpy()
        np.testing.assert_array_equal(ok, np.asarray(ref_res[e]), err_msg=f"resolved {e}")
        got, want = taps[e].numpy(), np.asarray(ref_taps[e])
        np.testing.assert_array_equal(got[ok], want[ok], err_msg=f"resolved taps {e}")
        np.testing.assert_array_equal(got, want, err_msg=f"taps {e}")
        # the contract: a resolved tap is the exact read
        yt = np.clip(np.clip(y0, 0, h - 1) + e[0], 0, h - 1)
        xt = np.clip(np.clip(x0, 0, w - 1) + e[1], 0, w - 1)
        np.testing.assert_array_equal(got[ok], atlas[yt, xt][ok])
    live = (y0 >= 0) & (y0 < h) & (x0 >= 0) & (x0 < w)  # the base tap in the image
    share = res[(0, 0)].numpy()[live].mean()
    if name in ("smooth", "static", "uniform_large_shift"):
        assert share > 0.9
    if name == "discontinuous":
        assert 0.3 < share < 0.9


def test_window_halo_and_clip_are_parameters():
    """A halo of 4 (the TPU kernel's) takes the minimum over more rows and
    columns: a strip of columns 1 and 2 of each tile whose history lies 6
    rows farther (past the span) lowers the window of the tile to its left
    under a halo of 4 only, so fewer taps resolve there; both keep the
    contract. A clip of the window base far inside leaves no tap resolved."""
    atlas, y0, x0, _, _, _ = _case("smooth")
    xx = np.arange(200)[None, :]
    y0 = y0 - np.where((xx % 40 == 1) | (xx % 40 == 2), 6, 0).astype(np.int32)
    a, t0, s0 = torch.from_numpy(atlas), torch.from_numpy(y0), torch.from_numpy(x0)
    _, r1 = tile_gather.tiled_taps(a, t0, s0, OFFS, span=4, ty=40, tx=40)
    taps, r4 = tile_gather.tiled_taps(a, t0, s0, OFFS, span=4, ty=40, tx=40, halo=4)
    for e in OFFS:
        assert (r4[e] <= r1[e]).all()
        ok = r4[e].numpy()
        yt = np.clip(np.clip(y0, 0, 199) + e[0], 0, 199)
        xt = np.clip(np.clip(x0, 0, 199) + e[1], 0, 199)
        np.testing.assert_array_equal(taps[e].numpy()[ok], atlas[yt, xt][ok])
    assert int(r4[(0, 0)].sum()) < int(r1[(0, 0)].sum())
    _, rc = tile_gather.tiled_taps(a, t0, s0, OFFS, clip_y=(500, 600))
    assert not any(bool(r.any()) for r in rc.values())


def test_history_atlas_layout():
    """The atlas is tpuray's build_atlas (its first output; the quad-packed
    second is left out), and the channel slices pick tpuray's split."""
    from tpuray.denoise import history_atlas as jatlas
    from tpuray_torch.denoise import history_atlas
    rng = np.random.default_rng(8)
    f = [rng.random(s).astype(np.float32)
         for s in ((6, 5, 3), (6, 5), (6, 5, 3), (6, 5), (6, 5, 2), (6, 5))]
    ref = np.asarray(jatlas.build_atlas(*map(jnp.asarray, f))[0])
    got = history_atlas.build_atlas(*map(torch.from_numpy, f)).numpy()
    np.testing.assert_array_equal(got, ref)
    fields = jatlas.split(jnp.asarray(ref))
    for name, sl in (("normal", history_atlas.NORMAL), ("linear_z", history_atlas.Z),
                     ("moments", history_atlas.MOMENTS),
                     ("history_len", history_atlas.HIST)):
        np.testing.assert_array_equal(got[..., sl], np.asarray(fields[name]))
    np.testing.assert_array_equal(
        got[..., history_atlas.IV],
        np.concatenate([fields["illum"], np.asarray(fields["variance"])[..., None]], -1))


H, W = 64, 96


@pytest.mark.parametrize("row0,rows", [(None, None), (12, 24), (-2, 20), (44, 22)])
def test_taa_tiled_fetch_matches_tpuray(row0, rows):
    """The moving history fetch of (0.4, -0.3) pixels, the left third's
    (-0.6, -0.3) (slow enough that the history keeps a share of the blend):
    tpuray's taa(tiled_fetch=True) and the port's, whole image and on a row
    slab (rows row0 .. row0 + rows - 1, edge rows replicated); the clamped
    read of the default fetch differs at the border."""
    rng = np.random.default_rng(9)
    g = gbuffer_arrays(rng, H, W, sky_rows=2)
    xx = np.arange(W)[None, :]
    a = dict(cur_color=rng.random((H, W, 3)).astype(np.float32),
             prev_color=rng.random((H, W, 3)).astype(np.float32),
             velocity=_motion(np.where(xx < W // 3, -0.6, 0.4), -0.3, H, W),
             linear_z=g["linear_z"])
    win = None
    if row0 is not None:
        a = {k: _slab(v, row0, rows) for k, v in a.items()}
        win = (row0, H)
    got = taa.taa(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()},
                  frame=3, tiled_fetch=True, row_window=win)
    ref = jtaa.taa(**{k: jnp.asarray(v) for k, v in a.items()}, frame=3, tiled_fetch=True,
                   row_window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    exact = taa.taa(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()},
                    frame=3, row_window=win)
    assert not torch.equal(got, exact)  # the two reads differ on this motion
