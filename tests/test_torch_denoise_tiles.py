"""The shared-memory tile schedules of K5 (csrc/atrous.cu) and K4
(csrc/reproject.cu), copied into torch and run on the CPU, where no kernel
runs.

Each copy repeats its kernel's schedule: the launch's blocks, the points
each block stages and from which clamped image coordinates, which staged
point each tap reads, the inside-the-image mask; and the kernel's
arithmetic: K5 multiplies by reciprocals taken once per pixel where the
plain version divides per tap, K4 divides per tap as it does. The tile constants are read from the CUDA
sources. Held against the plain versions (denoise/atrous.py:
atrous_iteration; denoise/variance.py:estimate_variance on
denoise/reproject.py:reproject), which tests/test_torch_denoise.py and
tests/test_torch_denoise_kernels.py hold against the JAX package:
- every staged value a tap reads is bit-equal to the plain version's
  clamped read of that tap, every pixel is written by exactly one thread,
  and K4's block tile is its own pixels plus its halo ring, once each;
- the outputs agree within rtol 1e-5 / atol 1e-6, chip_smoke.py's
  tolerance for the kernels against their plain versions.
Cases: ragged sizes (61 x 97, and 1080 rows as 1920 x 1080 has), images
smaller than the halo (5 x 7 at step 16; K4 at 2 x 2), an all-sky tile,
reference_quirks on and off, the history tap at 0, 1, 4 and past the
chain, K4 with no pixel and with every pixel taking the fallback, and the
row window of a sharded frame's rank (dist/frame.py): a slab of a taller
image, its edge rows replicated past the image as the first and last rank
hold them, staged and blurred with clamps in its own rows and masked with
the image's rows, against the plain versions with the same window.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuray_torch.denoise.atrous import VAR_KERNEL, atrous_iteration
from tpuray_torch.denoise.common import luminance, pow_weight, rdiv
from tpuray_torch.denoise.reproject import reproject
from tpuray_torch.denoise.variance import estimate_variance
from tpuray_torch.kernels import atrous as ka
from tpuray_torch.scene.config import RenderConfig

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
CSRC = Path(__file__).resolve().parents[1] / "tpuray_torch" / "csrc"


def _consts(source: str, *names: str) -> list[int]:
    """`constexpr int A = 32, B = 8;` values from a CUDA source."""
    text = (CSRC / source).read_text()
    return [int(re.search(rf"\b{n} = (\d+)", text).group(1)) for n in names]


TW, TH, R = _consts("atrous.cu", "TW", "TH", "R")   # K5: 32 pixels x 8 lattice rows, radius
BW, BH, HR = _consts("reproject.cu", "BW", "BH", "HR")  # K4: pixels a block, radius
K1D = (1.0, 2.0 / 3.0, 1.0 / 6.0)


def _close(got, ref, name):
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL, msg=name)


def _f32(x: float) -> float:
    return float(np.float32(x))


# ---------------------------------------------------------------- K5

def classes_x(step: int) -> int:
    """csrc/atrous.cu:classes_x: x classes a block covers side by side."""
    return 8 if step % 8 == 0 else 4 if step % 4 == 0 else 2 if step % 2 == 0 else 1


def k5_step_copy(illum, variance, normal, linear_z, fwidth_z, step, cfg, row_window=None):
    """One a-trous iteration as csrc/atrous.cu:atrous_step schedules it;
    row_window=(row0, global_h): the taps' inside bits take the image's
    rows as local bounds [-row0, global_h - row0), as the entry point
    passes them."""
    h, w = variance.shape
    row0, gh = row_window if row_window is not None else (0, h)
    s, cx = step, classes_x(step)
    lx = TW // cx
    sx = lx + 2 * R
    nbx = -(-(-(-w // s)) // lx)
    nby = -(-(-(-h // s)) // TH)
    by, bx = torch.meshgrid(torch.arange(nby * s), torch.arange(nbx * (s // cx)),
                            indexing="ij")
    by, bx = by.reshape(-1, 1), bx.reshape(-1, 1)
    rx0, ry = (bx % (s // cx)) * cx, by % s             # first x class, the y class
    li0, lj0 = (bx // (s // cx)) * lx, (by // s) * TH  # first lattice column, row
    e = torch.arange(sx * (TH + 2 * R) * cx)
    gx = torch.clamp(rx0 + e % cx + s * (li0 + (e // cx) % sx - R), 0, w - 1)
    gy = torch.clamp(ry + s * (lj0 + e // (cx * sx) - R), 0, h - 1)
    src = gy * w + gx                                  # (blocks, tile points)
    iv = torch.cat([illum, variance[..., None]], -1).reshape(-1, 4)
    nz = torch.cat([normal, linear_z[..., None]], -1).reshape(-1, 4)
    t_iv, t_nz, t_l = iv[src], nz[src], luminance(illum).reshape(-1)[src]

    t = torch.arange(TW * TH)
    tx, ty = t % TW, t // TW
    tc, tcol = tx % cx, tx // cx
    x = rx0 + tc + s * (li0 + tcol)
    y = ry + s * (lj0 + ty)
    blk = torch.arange(len(bx))[:, None].expand_as(x)
    c0 = (((ty + R) * sx + tcol + R) * cx + tc).expand_as(x)
    keep = (x < w) & (y < h)
    x, y, blk, c0 = x[keep], y[keep], blk[keep], c0[keep]
    i = y * w + x
    assert torch.equal(torch.bincount(i, minlength=h * w), torch.ones(h * w, dtype=torch.long))

    def staged(table, off):
        return table[blk, c0 + off]

    c, n, l_c = staged(t_iv, 0), staged(t_nz, 0), staged(t_l, 0)
    assert torch.equal(c, iv[i])                 # a thread's own point is its pixel
    if cfg.reference_quirks:
        var_blur = c[:, 3]
    else:
        var_blur = torch.zeros_like(l_c)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                clamped = (torch.clamp(y + dy, 0, h - 1) * w + torch.clamp(x + dx, 0, w - 1))
                v = staged(t_iv, dy * sx + dx)[:, 3] if s == 1 else variance.reshape(-1)[clamped]
                assert torch.equal(v, variance.reshape(-1)[clamped])
                var_blur = var_blur + VAR_KERNEL[(abs(dx), abs(dy))] * v
    phi_l = torch.clamp_min(cfg.sigma_l * torch.sqrt(torch.clamp_min(1e-10 + var_blur, 1e-10)),
                            1e-10)
    inv_l = rdiv(1.0, phi_l)
    phi_depth = torch.clamp_min(fwidth_z.reshape(-1)[i], 1e-8) * s
    sum_w = torch.ones_like(l_c)
    acc = c.clone()
    for yy in range(-2, 3):
        for xx in range(-2, 3):
            if xx == 0 and yy == 0:
                continue
            off = (yy * sx + xx) * cx
            q, tn, lq = staged(t_iv, off), staged(t_nz, off), staged(t_l, off)
            clamped = (torch.clamp(y + yy * s, 0, h - 1) * w
                       + torch.clamp(x + xx * s, 0, w - 1))
            assert torch.equal(q, iv[clamped]) and torch.equal(tn, nz[clamped])
            inside = ((x + xx * s >= 0) & (x + xx * s < w)
                      & (y + yy * s >= -row0) & (y + yy * s < gh - row0))
            inv_d = rdiv(1.0, phi_depth * _f32(math.sqrt(xx * xx + yy * yy)))
            w_normal = pow_weight(n[:, 0] * tn[:, 0] + n[:, 1] * tn[:, 1]
                                  + n[:, 2] * tn[:, 2], cfg.sigma_n)
            w_z = torch.abs(n[:, 3] - tn[:, 3]) * inv_d
            w_l = torch.abs(l_c - lq) * inv_l
            wgt = torch.exp(-w_l - w_z) * w_normal
            wgt = torch.where(inside, wgt * _f32(K1D[abs(xx)] * K1D[abs(yy)]), 0.0)
            sum_w = sum_w + wgt
            acc[:, :3] = acc[:, :3] + wgt[:, None] * q[:, :3]
            acc[:, 3] = acc[:, 3] + wgt * wgt * q[:, 3]
    out = torch.cat([acc[:, :3] / sum_w[:, None], (acc[:, 3] / (sum_w * sum_w))[:, None]], -1)
    out = torch.where((n[:, 3] == 1.0)[:, None], c, out)  # sky passthrough
    res = torch.empty_like(iv)
    res[i] = out
    res = res.reshape(h, w, 4)
    return res[..., :3].contiguous(), res[..., 3].contiguous()


def _k5_inputs(seed, h, w):
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n[..., 2] += 2.0  # mostly facing one way: the normal weight is not ~0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    z = rng.uniform(0.05, 0.95, (h, w)).astype(np.float32)
    z[: h // 4, : w // 3] = 1.0  # sky: passthrough
    arrays = (rng.uniform(0.0, 4.0, (h, w, 3)), rng.uniform(0.0, 1.0, (h, w)), n, z,
              rng.uniform(0.0, 0.02, (h, w)))
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("h,w,steps", [(61, 97, (1, 2, 4, 8, 16)), (1080, 40, (1, 16)),
                                       (5, 7, (1, 16))])
def test_k5_tiles_match_plain(h, w, steps, quirks):
    """Ragged sizes and an image smaller than step 16's halo."""
    cfg = RenderConfig(reference_quirks=quirks)
    args = _k5_inputs(h * w + quirks, h, w)
    for s in steps:
        got = k5_step_copy(*args, s, cfg)
        ref = atrous_iteration(*args, step=s, cfg=cfg)
        _close(got[0], ref[0], f"illum, step {s}")
        _close(got[1], ref[1], f"variance, step {s}")
        if s >= max(h, w):  # every tap outside the image: the identity
            assert torch.equal(got[0], args[0]) and torch.equal(got[1], args[1])
        elif h * w > 1000:
            assert float((got[0] - args[0]).abs().max()) > 0.1  # the filter did work


def _slab(x, row0, rows):
    """Rows row0 .. row0 + rows - 1 of a full-image tensor or array, its
    edge rows replicated past the image (what dist/frame.py:_halo_rows
    gives the first and the last rank)."""
    idx = np.clip(np.arange(row0, row0 + rows), 0, x.shape[0] - 1)
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(x[idx])
    return x.index_select(0, torch.from_numpy(idx).to(x.device)).contiguous()


def _sharded_stage(fn, xs, shards, k):
    """fn(slabs, (row0, H)) -> a tuple of tensors, run on each of `shards`
    row shards of the full-image tensors xs (a dict or a list) extended by
    k rows a side, cropped and stitched -> the full-image tuple: a sharded
    frame's stage emulated in one process."""
    h = next(iter(xs.values() if isinstance(xs, dict) else xs)).shape[0]
    rows = h // shards
    parts = []
    for r in range(shards):
        row0 = r * rows - k
        cut = ({n: _slab(x, row0, rows + 2 * k) for n, x in xs.items()}
               if isinstance(xs, dict) else [_slab(x, row0, rows + 2 * k) for x in xs])
        parts.append(fn(cut, (row0, h)))
    return tuple(torch.cat([p[i][k:-k] for p in parts]) for i in range(len(parts[0])))


@pytest.mark.parametrize("row0,rows", [(8, 40), (-4, 40), (37, 40)])
@pytest.mark.parametrize("steps", [(1, 2, 4), (8, 16)])
def test_k5_tiles_row_window(row0, rows, steps):
    """A halo-extended slab of a 61 x 97 image (row0 -4 and 37: the image's
    first and last rows replicated past it)."""
    cfg = RenderConfig()
    args = [_slab(x, row0, rows) for x in _k5_inputs(6, 61, 97)]
    for s in steps:
        got = k5_step_copy(*args, s, cfg, row_window=(row0, 61))
        ref = atrous_iteration(*args, step=s, cfg=cfg, row_window=(row0, 61))
        _close(got[0], ref[0], f"illum, step {s}")
        _close(got[1], ref[1], f"variance, step {s}")


def test_k5_tiles_other_sigma_n():
    """sigma_n = 3 (no power of two): the kernel's powf path."""
    cfg = RenderConfig(sigma_n=3.0)
    args = _k5_inputs(3, 24, 40)
    for s in (1, 4):
        got = k5_step_copy(*args, s, cfg)
        ref = atrous_iteration(*args, step=s, cfg=cfg)
        _close(got[0], ref[0], "illum")
        _close(got[1], ref[1], "variance")


def test_k5_all_sky_tile():
    """A block of sky passes its state through untouched; the ground
    beside it still filters."""
    args = _k5_inputs(4, 16, 64)
    args[3][:8, :32] = 1.0  # one whole 32 x 8 block at step 1
    got = k5_step_copy(*args, 1, RenderConfig())
    assert torch.equal(got[0][:8, :32], args[0][:8, :32])
    assert torch.equal(got[1][:8, :32], args[1][:8, :32])
    ref = atrous_iteration(*args, step=1, cfg=RenderConfig())
    _close(got[0], ref[0], "illum")
    _close(got[1], ref[1], "variance")


@pytest.mark.parametrize("tap", [0, 1, 4, 5])
def test_k5_chain_history_tap(tap):
    """The chain of 5 through the copy, the tap at 0, 1, 4 and past the
    chain (the chain's input, as the same objects): the tap is the chain
    of tap + 1 iterations' output."""
    cfg = RenderConfig(history_atrous_tap=tap)
    il, var, n, z, fwz = _k5_inputs(5, 37, 45)
    (gi, gv), (ti, tv) = ka.chain(k5_step_copy, il, var, n, z, fwz, cfg)
    (ri, rv), _ = ka.chain(atrous_iteration, il, var, n, z, fwz, cfg)
    _close(gi, ri, "illum")
    _close(gv, rv, "variance")
    if tap >= cfg.num_atrous_iterations:
        assert ti is il and tv is var
        return
    (ri, rv), _ = ka.chain(atrous_iteration, il, var, n, z, fwz,
                           RenderConfig(num_atrous_iterations=tap + 1))
    _close(ti, ri, "tap illum")
    _close(tv, rv, "tap variance")


# ---------------------------------------------------------------- K4

def ring_point(k: int) -> tuple[int, int]:
    """csrc/reproject.cu:ring_point: halo point k of a block's tile."""
    sw, sh = BW + 2 * HR, BH + 2 * HR
    if k < 2 * HR * sw:
        band, rem = divmod(k, HR * sw)
        return rem % sw, band * (sh - HR) + rem // sw
    k -= 2 * HR * sw
    c = k % (2 * HR)
    return (c if c < HR else BW + c), HR + k // (2 * HR)


def k4_fallback_copy(cfg, row_window=None, **inputs):
    """(var_illum, var_variance, blocks that staged a tile, blocks) as
    csrc/reproject.cu:reproject_variance schedules the fallback, on the
    plain reprojection (the kernel's reproject_px repeats its op order);
    row_window=(row0, global_h): the tile clamps to the rows in memory, the
    inside bits take image rows."""
    rep = reproject(**inputs, cfg=cfg, row_window=row_window)
    h, w = rep.history_len.shape
    row0, gh = row_window if row_window is not None else (0, h)
    sw, sh = BW + 2 * HR, BH + 2 * HR
    own = [(ty + HR) * sw + tx + HR for ty in range(BH) for tx in range(BW)]
    ring = [ring_point(k) for k in range(sw * sh - BW * BH)]
    assert sorted(own + [ey * sw + ex for ex, ey in ring]) == list(range(sw * sh))

    nbx, nby = -(-w // BW), -(-h // BH)
    by, bx = torch.meshgrid(torch.arange(nby) * BH, torch.arange(nbx) * BW, indexing="ij")
    bx, by = bx.reshape(-1, 1), by.reshape(-1, 1)
    e = torch.arange(sw * sh)
    src = (torch.clamp(by + e // sw - HR, 0, h - 1) * w
           + torch.clamp(bx + e % sw - HR, 0, w - 1))
    il = rep.illum.reshape(-1, 3)
    t_il, t_l = il[src], luminance(rep.illum).reshape(-1)[src]
    t_n, t_z = inputs["normal"].reshape(-1, 3)[src], inputs["linear_z"].reshape(-1)[src]
    t_m = rep.moments.reshape(-1, 2)[src]

    t = torch.arange(BW * BH)
    x, y = bx + t % BW, by + t // BW
    blk = torch.arange(len(bx))[:, None].expand_as(x)
    c0 = ((t // BW + HR) * sw + t % BW + HR).expand_as(x)
    in_img = (x < w) & (y < h)
    needs = in_img & (rep.history_len.reshape(-1)[torch.clamp(y, max=h - 1) * w
                                                  + torch.clamp(x, max=w - 1)] < 4.0)
    needs &= inputs["linear_z"].reshape(-1)[torch.clamp(y, max=h - 1) * w
                                            + torch.clamp(x, max=w - 1)] != 1.0
    staged = needs.any(dim=1)  # __syncthreads_or
    var_il = rep.illum.clone().reshape(-1, 3)
    var_v = rep.variance.clone().reshape(-1)
    sel = needs & staged[:, None]
    x, y, blk, c0 = x[sel], y[sel], blk[sel], c0[sel]
    i = y * w + x
    z, n, hl = inputs["linear_z"].reshape(-1)[i], inputs["normal"].reshape(-1, 3)[i], \
        rep.history_len.reshape(-1)[i]
    l_c = t_l[blk, c0]
    phi_depth = torch.clamp_min(inputs["fwidth_z"].reshape(-1)[i], 1e-8) * 3.0
    phi_l = torch.clamp_min(torch.full_like(l_c, cfg.sigma_l), 1e-10)
    sum_w = torch.zeros_like(l_c)
    s_il = torch.zeros_like(n)
    s_m = torch.zeros((len(i), 2))
    for dy in range(-HR, HR + 1):
        for dx in range(-HR, HR + 1):
            e = c0 + dy * sw + dx
            j = torch.clamp(y + dy, 0, h - 1) * w + torch.clamp(x + dx, 0, w - 1)
            assert torch.equal(t_il[blk, e], il[j])
            assert torch.equal(t_z[blk, e], inputs["linear_z"].reshape(-1)[j])
            gn = t_n[blk, e]
            w_normal = pow_weight(n[:, 0] * gn[:, 0] + n[:, 1] * gn[:, 1] + n[:, 2] * gn[:, 2],
                                  cfg.sigma_n)
            phi_d = phi_depth * _f32(math.sqrt(dx * dx + dy * dy))
            w_z = torch.where(phi_d == 0.0, 0.0, torch.abs(z - t_z[blk, e]) / phi_d)
            w_l = torch.abs(l_c - t_l[blk, e]) / phi_l
            wgt = torch.exp(-w_l - w_z) * w_normal
            inside = ((x + dx >= 0) & (x + dx < w)
                      & (y + row0 + dy >= 0) & (y + row0 + dy < gh))
            wgt = torch.where(inside, wgt, 0.0)
            sum_w = sum_w + wgt
            s_il = s_il + wgt[:, None] * t_il[blk, e]
            s_m = s_m + wgt[:, None] * t_m[blk, e]
    sum_w = torch.clamp_min(sum_w, 1e-6)
    var_il[i] = s_il / sum_w[:, None]
    m = s_m / sum_w[:, None]
    var_v[i] = (m[:, 1] - m[:, 0] * m[:, 0]) * rdiv(4.0, torch.clamp_min(hl, 1e-3))
    return var_il.reshape(h, w, 3), var_v.reshape(h, w), int(staged.sum()), len(staged)


def _k4_inputs(seed, h, w, case):
    """Moving-frame inputs with motion discontinuities and a sky band; no
    pixel or every pixel taking the fallback by case."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    n = np.zeros((h, w, 3), np.float32)
    n[..., 2] = 1.0
    n += 0.2 * rng.standard_normal((h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    z = (2.0 + 0.01 * xx + 0.02 * yy + 0.01 * rng.random((h, w))).astype(np.float32)
    z[: h // 8] = 1.0
    mx = np.full((h, w), 1.6, np.float32) + 0.5 * rng.random((h, w)).astype(np.float32)
    my = np.full((h, w), -0.7, np.float32)
    mx[h // 6: h // 2, w // 5: w // 2] = -6.3
    my[h // 2: 5 * h // 6, w // 3: 3 * w // 4] = 9.2
    prev_z = z.copy()
    prev_z[h // 4: h // 3, 2 * w // 3:] += 4.0
    hist = np.floor(9 * rng.random((h, w)))
    if case != "mixed":  # motion 0 and a valid history: every bilinear tap holds
        mx[:], my[:], prev_z = 0.0, 0.0, z.copy()
        hist[:] = 8.0 if case == "none" else 0.0
    f = lambda *s: rng.random(s)
    arrays = dict(
        color=f(h, w, 3), emission=0.1 * f(h, w, 3), albedo=f(h, w, 3),
        motion=np.stack([mx / w, my / h], -1), normal=n, linear_z=z,
        fwidth_normal=0.01 + 0.1 * f(h, w), fwidth_z=0.005 + 0.03 * f(h, w),
        prev_illum=f(h, w, 3), prev_variance=f(h, w), prev_normal=n.copy(),
        prev_linear_z=prev_z, prev_moments=f(h, w, 2), prev_history_len=hist)
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in arrays.items()}


@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("h,w,case", [(61, 97, "mixed"), (1080, 40, "mixed"), (2, 2, "mixed"),
                                      (2, 2, "all"), (40, 72, "none"), (40, 72, "all")])
def test_k4_tiles_match_plain(h, w, case, quirks):
    cfg = RenderConfig(reference_quirks=quirks)
    a = _k4_inputs(h + w, h, w, case)
    got_il, got_v, staged, blocks = k4_fallback_copy(cfg, **a)
    rep = reproject(**a, cfg=cfg)
    ref = estimate_variance(rep.illum, rep.variance, rep.moments, rep.history_len,
                            a["normal"], a["linear_z"], a["fwidth_z"], cfg)
    _close(got_il, ref.illum, "var_illum")
    _close(got_v, ref.variance, "var_variance")
    needs = (rep.history_len < 4) & (a["linear_z"] != 1.0)
    if case == "none":
        assert staged == 0 and not bool(needs.any())
        assert torch.equal(got_il, rep.illum) and torch.equal(got_v, rep.variance)
    elif case == "all":
        assert bool(needs[a["linear_z"] != 1.0].all()) and staged == blocks
    else:
        assert 0 < staged and bool(needs.any()) and not bool(needs.all())


@pytest.mark.parametrize("row0,rows", [(12, 30), (-7, 30), (38, 30)])
def test_k4_tiles_row_window(row0, rows):
    """A halo-extended slab of a 61 x 97 image (row0 -7 and 38: the image's
    first and last rows replicated past it)."""
    cfg = RenderConfig()
    a = {k: _slab(v, row0, rows) for k, v in _k4_inputs(9, 61, 97, "mixed").items()}
    win = (row0, 61)
    got_il, got_v, staged, _ = k4_fallback_copy(cfg, row_window=win, **a)
    rep = reproject(**a, cfg=cfg, row_window=win)
    ref = estimate_variance(rep.illum, rep.variance, rep.moments, rep.history_len,
                            a["normal"], a["linear_z"], a["fwidth_z"], cfg, row_window=win)
    _close(got_il, ref.illum, "var_illum")
    _close(got_v, ref.variance, "var_variance")
    assert staged > 0
