"""K4 and K5's wrappers on the CPU, against the JAX package's Pallas kernels
run in interpret mode.

On CPU tensors the wrappers run their plain versions and count no launch.

- K5 (kernels/atrous.py:atrous_step, chained) against
  tpuray.kernels.atrous_pallas.atrous_chain(interpret=True) at the size of
  tests/test_atrous_pallas.py, under both quirk settings: rtol 2e-5 /
  atol 2e-5, that test's own tolerance. The two sides differ by last-bit
  rounding (the TPU kernel and XLA contract multiply-adds; the port does
  not), grown by the seven squarings of the normal weight.
- K4 (kernels/reproject.py:reproject_variance_fused) under
  reproject_gather="tiled" computes what the TPU kernel computes: against
  tpuray.kernels.reproject_pallas.reproject_variance_fused(interpret=True)
  on the five cases of tests/test_reproject_pallas.py (smooth motion with a
  rescue block, the fallback and a sky band, a varying field, per-pixel
  random motion, a shape no multiple of the tiles) over the whole image,
  border included: rtol 2e-5 / atol 2e-5, history_len exact.
- K4 under fast_reproject=True against tpuray's reproject(fast_reproject=
  True) composed with estimate_variance, on the same cases, at the same
  tolerance.
- K4 under the default config (the exact read) against the TPU kernel on
  one smooth-motion case, on the interior only: there the exact and the
  tile-windowed reads take the same texels. The reprojected fields agree
  from 4 pixels in (the bilinear and rescue taps lie inside the image);
  the fallback's 7x7 window reads them, so the variance fields agree from
  4 + 3 pixels in.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuray.denoise.reproject import reproject as j_reproject
from tpuray.denoise.variance import estimate_variance as j_estimate_variance
from tpuray.kernels import atrous_pallas, reproject_pallas
from tpuray.scene.config import RenderConfig as JRenderConfig

from tpuray_torch.kernels import atrous, reproject
from tpuray_torch.scene.config import RenderConfig

torch.set_num_threads(2)

RTOL = ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got, ref, name, where=np.s_[:]):
    np.testing.assert_allclose(np.asarray(got)[where], np.asarray(ref)[where],
                               rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("quirks", [False, True])
def test_k5_chain_matches_pallas(quirks):
    h, w = 48, 72
    rng = np.random.default_rng(1 + quirks)
    illum = rng.uniform(0.0, 4.0, (h, w, 3)).astype(np.float32)
    variance = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    z = rng.uniform(0.05, 0.95, (h, w)).astype(np.float32)
    z[: h // 5, : w // 3] = 1.0  # sky: passthrough
    fwz = rng.uniform(0.0, 0.02, (h, w)).astype(np.float32)
    args = (illum, variance, n, z, fwz)
    (ri, rv), (rti, rtv) = atrous_pallas.atrous_chain(
        *map(jnp.asarray, args),
        JRenderConfig(num_atrous_iterations=3, reference_quirks=quirks),
        interpret=True)
    atrous.reset_launches()
    (gi, gv), (gti, gtv) = atrous.chain(
        atrous.atrous_step, *map(_t, args),
        RenderConfig(num_atrous_iterations=3, reference_quirks=quirks))
    assert atrous.LAUNCHES["k5"] == 0
    for got, ref, name in ((gi, ri, "illum"), (gv, rv, "variance"),
                           (gti, rti, "tap illum"), (gtv, rtv, "tap variance")):
        _close(got, ref, name)
    assert np.abs(gi.numpy() - illum).max() > 0.1  # the filter did work


def test_k5_tap_beyond_the_chain_is_its_input():
    rng = np.random.default_rng(3)
    args = [_t(rng.random(s).astype(np.float32))
            for s in ((8, 8, 3), (8, 8), (8, 8, 3), (8, 8), (8, 8))]
    _, (ti, tv) = atrous.chain(
        atrous.atrous_step, *args, RenderConfig(num_atrous_iterations=1, history_atrous_tap=1))
    assert ti is args[0] and tv is args[1]


def test_k4_matches_pallas_on_the_interior():
    h, w = 64, 256
    rng = np.random.default_rng(7)
    normal = np.broadcast_to(np.float32([0.0, 0.0, 1.0]), (h, w, 3))
    z = (rng.random((h, w)) * 0.5 + 0.2).astype(np.float32)
    prev_z = z.copy()
    prev_z[8:16, 8:16] += 5.0  # the bilinear taps fail here: the rescue runs
    motion = np.stack([np.full((h, w), 2.25 / w), np.full((h, w), 1.5 / h)],
                      axis=-1).astype(np.float32)
    a = dict(
        color=rng.random((h, w, 3)).astype(np.float32),
        emission=np.zeros((h, w, 3), np.float32),
        albedo=np.full((h, w, 3), 0.5, np.float32),
        motion=motion, normal=normal, linear_z=z,
        fwidth_normal=np.full((h, w), 0.05, np.float32),
        fwidth_z=np.full((h, w), 0.01, np.float32),
        prev_illum=rng.random((h, w, 3)).astype(np.float32),
        prev_variance=rng.random((h, w)).astype(np.float32),
        prev_normal=normal, prev_linear_z=prev_z,
        prev_moments=rng.random((h, w, 2)).astype(np.float32),
        prev_history_len=np.where(rng.random((h, w)) < 0.3, 1.0, 5.0)
        .astype(np.float32))
    ref = reproject_pallas.reproject_variance_fused(
        **{k: jnp.asarray(v) for k, v in a.items()},
        cfg=JRenderConfig(width=w, height=h, reproject_gather="tiled"),
        interpret=True)
    reproject.reset_launches()
    got = reproject.reproject_variance_fused(
        cfg=RenderConfig(width=w, height=h), **{k: _t(v) for k, v in a.items()})
    assert reproject.LAUNCHES["k4"] == 0
    assert got._fields == ref._fields
    for f in got._fields:
        inner = np.s_[7:-7, 7:-7] if f.startswith("var_") else np.s_[4:-4, 4:-4]
        if f == "history_len":
            np.testing.assert_array_equal(got.history_len.numpy()[inner],
                                          np.asarray(ref.history_len)[inner])
        else:
            _close(getattr(got, f), getattr(ref, f), f, inner)
    hl = got.history_len.numpy()
    assert (hl[8:16, 8:16] == 6.0).any() or (hl[8:16, 8:16] == 2.0).any()
    assert (hl < 4).any() and (hl >= 4).any()  # both sides of the fallback


def _pallas_case(name):
    """tests/test_reproject_pallas.py's inputs of case `name` (its seed, 7)."""
    rng = np.random.default_rng(7)
    h, w = (48, 200) if name == "non_divisible" else (64, 256)
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    motions = dict(
        smooth=(np.full((h, w), 2.25 / w), np.full((h, w), 1.5 / h)),
        fallback_sky=(np.full((h, w), -1.75 / w), np.full((h, w), 0.5 / h)),
        varying=((xx / w - 0.5) * 4.0 / w + 1.2 / w, (yy / h - 0.5) * 3.0 / h - 0.7 / h),
        non_divisible=(np.full((h, w), 1.25 / w), np.full((h, w), -0.5 / h)))
    normal = np.broadcast_to(np.float32([0.0, 0.0, 1.0]), (h, w, 3))
    z = (rng.random((h, w)) * 0.5 + 0.2).astype(np.float32)
    motion = (np.stack(motions[name], -1) if name in motions
              else rng.random((h, w, 2)) - 0.5).astype(np.float32)  # "wild"
    a = dict(
        color=rng.random((h, w, 3)).astype(np.float32),
        emission=np.zeros((h, w, 3), np.float32),
        albedo=np.full((h, w, 3), 0.5, np.float32),
        motion=motion, normal=normal, linear_z=z,
        fwidth_normal=np.full((h, w), 0.05, np.float32),
        fwidth_z=np.full((h, w), 0.01, np.float32),
        prev_illum=rng.random((h, w, 3)).astype(np.float32),
        prev_variance=rng.random((h, w)).astype(np.float32),
        prev_normal=normal, prev_linear_z=z.copy(),
        prev_moments=rng.random((h, w, 2)).astype(np.float32),
        prev_history_len=np.full((h, w), 5.0, np.float32))
    if name == "smooth":
        a["prev_linear_z"][8:16, 8:16] += 5.0  # the rescue runs in this block
    if name == "fallback_sky":
        a["prev_history_len"] = (rng.random((h, w)) * 6).astype(np.float32)
        a["linear_z"][0:8] = 1.0
        a["prev_linear_z"] = a["linear_z"].copy()
    return a


PALLAS_CASES = ["smooth", "fallback_sky", "varying", "wild", "non_divisible"]


def _assert_k4_matches(got, ref):
    assert got._fields == ref._fields
    for f in got._fields:
        if f == "history_len":
            np.testing.assert_array_equal(got.history_len.numpy(), np.asarray(ref.history_len))
        else:
            _close(getattr(got, f), getattr(ref, f), f)


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_k4_tiled_matches_pallas(name):
    """The whole image, the border and the tiles' seams included."""
    a = _pallas_case(name)
    h, w = a["linear_z"].shape
    ref = reproject_pallas.reproject_variance_fused(
        **{k: jnp.asarray(v) for k, v in a.items()},
        cfg=JRenderConfig(width=w, height=h, reproject_gather="tiled"), interpret=True)
    reproject.reset_launches()
    got = reproject.reproject_variance_fused(
        cfg=RenderConfig(width=w, height=h, reproject_gather="tiled"),
        **{k: _t(v) for k, v in a.items()})
    assert reproject.LAUNCHES["k4"] == 0
    _assert_k4_matches(got, ref)
    hl = got.history_len.numpy()
    if name == "wild":
        assert hl.mean() < 3.0  # most reprojections fail
    else:
        assert (hl > 1.0).mean() > 0.5  # most extend their history
    # the exact read gives another function on every case but the varying
    # field's smooth interior
    exact = reproject.reproject_variance_fused(
        cfg=RenderConfig(width=w, height=h), **{k: _t(v) for k, v in a.items()})
    assert not torch.equal(exact.rep_illum, got.rep_illum)


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_k4_fast_matches_tpuray(name):
    a = _pallas_case(name)
    h, w = a["linear_z"].shape
    jcfg = JRenderConfig(width=w, height=h, fast_reproject=True)
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    rep = j_reproject(**ja, cfg=jcfg)
    var = j_estimate_variance(rep.illum, rep.variance, rep.moments, rep.history_len,
                              ja["normal"], ja["linear_z"], ja["fwidth_z"], jcfg)
    ref = reproject.FusedOutput(rep_illum=rep.illum, rep_variance=rep.variance,
                                var_illum=var.illum, var_variance=var.variance,
                                moments=rep.moments, history_len=rep.history_len)
    got = reproject.reproject_variance_fused(
        cfg=RenderConfig(width=w, height=h, fast_reproject=True),
        **{k: _t(v) for k, v in a.items()})
    _assert_k4_matches(got, ref)


def test_k4_wrapper_raises_for_tpu_only_reads():
    """The wrapper takes every read of tpuray's RenderConfig and raises for
    a read it does not know."""
    a = {k: _t(v[:8, :16]) for k, v in _pallas_case("smooth").items()}
    for cfg in (RenderConfig(reproject_gather="tiled"), RenderConfig(fast_reproject=True),
                RenderConfig(reproject_gather="exact")):
        out = reproject.reproject_variance_fused(cfg=cfg, **a)
        assert all(bool(torch.isfinite(x).all()) for x in out)
    with pytest.raises(ValueError, match="unknown reproject_gather"):
        reproject.reproject_variance_fused(cfg=RenderConfig(reproject_gather="quad"), **a)
