"""Traversal kernels K1 (trace_packets), K2 (trace_multi) and K3
(trace_batched).

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against tpuray.kernels.trace_pallas in Pallas interpret mode, at the
sizes of tests/test_pallas_kernel.py. Tolerances: closest-hit idx exact
and t within rtol 1e-5 (interpret mode runs the Pallas body through XLA,
which may contract the plane dot products n.o and n.d into FMAs; where
n.o nearly cancels n.p0 that moves t by a few ulps; the port's own plain
trace equals intersect.trace to rtol 1e-6, tests/test_torch_intersect.py);
any-hit classes hit/miss only (the triangle found first depends on walk
order).

The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_gpu.py (which imports no jax)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

from tpuray.scene.procedural import make_test_scene

from tpuray_torch.kernels import trace as kt
from tpuray_torch.scene.types import scene_from_numpy, scene_to_numpy

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def interp_trace():
    """trace_pallas with pallas_call forced into interpreter mode."""
    import importlib

    import tpuray.kernels.trace_pallas as tp
    orig_call = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig_call(*a, **k)

    pl.pallas_call = interp_call
    importlib.reload(tp)
    yield tp
    pl.pallas_call = orig_call
    importlib.reload(tp)


@pytest.fixture(scope="module")
def scenes():
    js = make_test_scene(subdiv=2, env_width=32)
    ts = scene_from_numpy(scene_to_numpy(js))
    return js, ts, kt.pack_scene(ts.bvh, ts.triangles)


def make_rays(seed, n, common_origin=False):
    rng = np.random.default_rng(seed)
    o = np.tile(np.asarray([[0.0, 0.3, 2.0]], np.float32), (n, 1))
    if not common_origin:
        o += (rng.random((n, 3)).astype(np.float32) - 0.5) * 0.4
    tgt = (rng.random((n, 3)).astype(np.float32) - 0.5) * 1.5
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_closest(t, i, t_ref, i_ref):
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    m = np.asarray(i_ref) >= 0
    np.testing.assert_allclose(t.numpy()[m], np.asarray(t_ref)[m], rtol=1e-5)


def test_pack_scene_matches(interp_trace, scenes):
    js, _, tables = scenes
    meta, aabb, tverts = interp_trace.pack_scene(js.bvh, js.triangles)
    np.testing.assert_array_equal(tables.meta.numpy(), np.asarray(meta))
    np.testing.assert_array_equal(tables.aabb.numpy(), np.asarray(aabb))
    np.testing.assert_allclose(tables.tverts.numpy(), np.asarray(tverts),
                               rtol=1e-6, atol=1e-7)
    assert tables.meta.dtype == torch.int32 and tables.meta.is_contiguous()


def test_pack_scene_rejects_wide_or_deep_trees(scenes):
    _, ts, _ = scenes
    wide = torch.tensor([9], dtype=torch.int32)
    bad = ts.bvh.to("cpu")
    bad = type(bad)(aabb_min=bad.aabb_min[:1], aabb_max=bad.aabb_max[:1],
                    first_tri=bad.first_tri[:1], tri_count=wide,
                    skip=bad.skip[:1].clone().fill_(1))
    with pytest.raises(ValueError, match="MAX_LEAF"):
        kt.pack_scene(bad, ts.triangles)
    # a 130-deep chain of inner nodes: no child order fits the stack
    n = 2 * 130 + 1
    skip = np.zeros(n, np.int32)
    count = np.zeros(n, np.int32)
    for k in range(130):  # inner node 2k: left child 2k+1 (leaf), right 2k+2
        skip[2 * k + 1] = 2 * k + 2
    skip[0::2] = n
    count[1::2] = 1
    count[-1] = 1
    with pytest.raises(ValueError, match="stack"):
        kt._check_tree(skip, count)


@pytest.mark.parametrize("n", [2048, 777])
def test_k1_closest_matches_pallas(interp_trace, scenes, n):
    js, _, tables = scenes
    o, d = make_rays(n, n)
    t_ref, i_ref = interp_trace.trace_pallas(js.bvh, js.triangles,
                                             jnp.asarray(o), jnp.asarray(d))
    tm = np.full((n,), 1e30, np.float32)
    t, i = kt.trace_packets(tables, *_t(o, d, tm))
    _assert_closest(t, i, t_ref, i_ref)
    assert (np.asarray(i_ref) >= 0).mean() > 0.3


def test_k1_common_origin_matches_pallas(interp_trace, scenes):
    js, _, tables = scenes
    o, d = make_rays(5, 2048, common_origin=True)
    t_ref, i_ref = interp_trace.trace_pallas(
        js.bvh, js.triangles, jnp.asarray(o), jnp.asarray(d),
        common_origin=True)
    tm = np.full((2048,), 1e30, np.float32)
    t, i = kt.trace_packets(tables, *_t(o[:1], d, tm), common_origin=True)
    _assert_closest(t, i, t_ref, i_ref)


def test_k1_any_hit_and_dead_lanes_match_pallas(interp_trace, scenes):
    js, _, tables = scenes
    n = 1024
    o, d = make_rays(6, n)
    o[: n // 2] = 0.0  # inside the unit-box scene: negative slab t0
    dead = np.arange(n) % 3 == 0
    tm = np.where(dead, 0.0, 1.5).astype(np.float32)
    _, ia_ref = interp_trace.trace_pallas(js.bvh, js.triangles, jnp.asarray(o),
                                          jnp.asarray(d), t_max=jnp.asarray(tm),
                                          any_hit=True)
    _, ia = kt.trace_packets(tables, *_t(o, d, tm), any_hit=True)
    np.testing.assert_array_equal(ia.numpy() >= 0, np.asarray(ia_ref) >= 0)
    assert (ia.numpy()[dead] == -1).all()
    t, i = kt.trace_packets(tables, *_t(o, d, tm))
    t_ref, i_ref = interp_trace.trace_pallas(js.bvh, js.triangles,
                                             jnp.asarray(o), jnp.asarray(d),
                                             t_max=jnp.asarray(tm))
    _assert_closest(t, i, t_ref, i_ref)
    assert (t.numpy()[dead] >= 1e29).all()


def _multi_inputs(n, seed):
    rng = np.random.default_rng(seed)
    o, d_b = make_rays(seed, n)
    d_e = rng.standard_normal((n, 3)).astype(np.float32)
    d_e /= np.linalg.norm(d_e, axis=-1, keepdims=True)
    d_p = -d_e + 0.3
    d_p /= np.linalg.norm(d_p, axis=-1, keepdims=True)
    inf = np.full((n,), 1e30, np.float32)
    tm_e = np.where(np.arange(n) % 4 == 0, 0.0, 1e30).astype(np.float32)
    tm_p = np.full((n,), 1.2, np.float32)
    return o, [d_b, d_e, d_p], [inf, tm_e, tm_p]


def test_k2_three_classes_match_pallas(interp_trace, scenes):
    js, _, tables = scenes
    n = 2048
    o, dirs, tms = _multi_inputs(n, 7)
    ah = (False, True, True)
    meta, aabb, tverts = interp_trace.pack_scene(js.bvh, js.triangles)
    ref = interp_trace.trace_multi(meta, aabb, tverts, jnp.asarray(o),
                                   [jnp.asarray(x) for x in dirs],
                                   [jnp.asarray(x) for x in tms],
                                   any_hits=ah, batch_k=2)
    got = kt.trace_multi(tables, *_t(o), _t(*dirs), _t(*tms), ah)
    _assert_closest(got[0][0], got[0][1], *ref[0])
    for c in (1, 2):
        np.testing.assert_array_equal(got[c][1].numpy() >= 0,
                                      np.asarray(ref[c][1]) >= 0)
    assert (got[1][1].numpy()[np.arange(n) % 4 == 0] == -1).all()


def test_k2_two_any_hit_classes_match_separate_traces(scenes):
    """The last bounce's pair (env + point shadow, both any-hit) against
    one tpuray.integrator.intersect.trace per class."""
    from tpuray.integrator.intersect import trace as trace_xla
    js, _, tables = scenes
    n = 1024
    o, dirs, tms = _multi_inputs(n, 8)
    dirs, tms, ah = dirs[1:], tms[1:], (True, True)
    got = kt.trace_multi(tables, *_t(o), _t(*dirs), _t(*tms), ah)
    for c in (0, 1):
        _, i_ref = trace_xla(js.bvh, js.triangles, jnp.asarray(o),
                             jnp.asarray(dirs[c]), t_max=jnp.asarray(tms[c]),
                             any_hit=True)
        np.testing.assert_array_equal(got[c][1].numpy() >= 0,
                                      np.asarray(i_ref) >= 0)


def test_cpu_path_counts_no_launch_and_rejects_other_devices(scenes):
    _, _, tables = scenes
    o, d = make_rays(9, 64)
    kt.reset_launches()
    kt.trace_packets(tables, *_t(o, d), 1e30)
    kt.trace_batched(tables, *_t(o, d), 1e30)
    kt.trace_multi(tables, *_t(o), _t(d), [1e30], [False])
    assert kt.LAUNCHES == {"k1": 0, "k2": 0, "k3": 0}
    meta_d = torch.empty((64, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kt.trace_packets(tables, meta_d, meta_d, 1e30)
    with pytest.raises(ValueError, match="unsupported device"):
        kt.trace_batched(tables, meta_d, meta_d, 1e30)
    with pytest.raises(ValueError, match="1..3 classes"):
        kt.trace_multi(tables, *_t(o), _t(d, d, d, d), [1e30] * 4, [True] * 4)


def test_k3_matches_batched_pallas(interp_trace, scenes):
    """K3: per-ray origins, some inside the scene's boxes, and dead lanes;
    closest hit against the TPU kernel _kernel_batched (batch_k > 0), any
    hit with a finite t_max against tpuray.integrator.intersect.trace."""
    from tpuray.integrator.intersect import trace as trace_xla
    js, _, tables = scenes
    n = 1500
    o, d = make_rays(12, n)
    o[: n // 4] = 0.0
    dead = np.arange(n) % 5 == 0
    tm = np.where(dead, 0.0, 1e30).astype(np.float32)
    t_ref, i_ref = interp_trace.trace_pallas(
        js.bvh, js.triangles, jnp.asarray(o), jnp.asarray(d),
        t_max=jnp.asarray(tm), batch_k=2)
    t, i = kt.trace_batched(tables, *_t(o, d, tm))
    _assert_closest(t, i, t_ref, i_ref)
    assert (i.numpy()[dead] == -1).all()
    assert 0.1 < (np.asarray(i_ref) >= 0).mean() < 0.95
    tm = np.where(dead, 0.0, 1.6).astype(np.float32)
    _, ia_ref = trace_xla(js.bvh, js.triangles, jnp.asarray(o), jnp.asarray(d),
                          t_max=jnp.asarray(tm), any_hit=True)
    _, ia = kt.trace_batched(tables, *_t(o, d, tm), any_hit=True)
    np.testing.assert_array_equal(ia.numpy() >= 0, np.asarray(ia_ref) >= 0)
