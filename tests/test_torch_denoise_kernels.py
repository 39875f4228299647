"""K4 and K5's wrappers on the CPU, against the JAX package's Pallas kernels
run in interpret mode.

On CPU tensors the wrappers run their plain versions and count no launch.

- K5 (kernels/atrous.py:atrous_step, chained) against
  tpuray.kernels.atrous_pallas.atrous_chain(interpret=True) at the size of
  tests/test_atrous_pallas.py, under both quirk settings: rtol 2e-5 /
  atol 2e-5, that test's own tolerance. The two sides differ by last-bit
  rounding (the TPU kernel and XLA contract multiply-adds; the port does
  not), grown by the seven squarings of the normal weight.
- K4 (kernels/reproject.py:reproject_variance_fused) against
  tpuray.kernels.reproject_pallas.reproject_variance_fused(interpret=True)
  on one smooth-motion case with a rescue block, at the size of
  tests/test_reproject_pallas.py, on the interior. The TPU kernel computes
  the tile-windowed history read, the port the exact one; under constant
  motion the two read the same texels away from the border, so the
  tolerance is the same 2e-5, history_len exact. The reprojected fields
  agree from 4 pixels in (that test's interior: the bilinear and rescue
  taps lie inside the image); the fallback's 7x7 window reads them, so the
  variance fields agree from 4 + 3 pixels in.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

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


def test_k4_wrapper_raises_for_tpu_only_reads():
    x = torch.zeros((4, 4))
    with pytest.raises(NotImplementedError, match="TPU-only"):
        reproject.reproject_variance_fused(
            cfg=RenderConfig(reproject_gather="tiled"), color=x)
