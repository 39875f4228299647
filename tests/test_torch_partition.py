"""Large scenes in the port: scene/partition.py, make_large_scene and K6's
plain version (kernels/trace_chunked.py) against the JAX package, on the
CPU, at the size of tests/test_partition.py (6 icospheres at subdiv 2 in
chunks of <= 512 triangles: 1,922 triangles, 4 chunks).

Tolerances: forest arrays and scene arrays exact (the port's partition is
a numpy copy built with the same numpy BVH builder; the JAX scene is built
with that builder forced). Traversal against tpuray.integrator.intersect
.trace and against tpuray.kernels.trace_chunked in Pallas interpret mode:
closest-hit idx exact, t within rtol 1e-5 / atol 1e-6 (XLA on the CPU
may contract n.o and n.d into FMAs; where n.o nearly cancels n.p0 that
moves t by a few ulps of the plane offset, an absolute error that a short
t feels as a relative one; as in tests/test_torch_trace_kernels.py);
any-hit hit/miss exact."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

import tpuray.scene.partition as jpart
from tpuray.accel.bvh import build_bvh
from tpuray.integrator.intersect import trace as trace_xla
from tpuray.scene.procedural import make_large_scene as jmake_large_scene

from tpuray_torch.integrator import intersect
from tpuray_torch.integrator.path_tracer import pack_traversal
from tpuray_torch.kernels import trace as kt
from tpuray_torch.kernels import trace_chunked as ktc
from tpuray_torch.scene import partition
from tpuray_torch.scene.procedural import (
    icosphere, ground_quad, make_large_scene_arrays)
from tpuray_torch.scene.types import scene_from_numpy, scene_to_numpy

from tests.test_torch_native import port_numpy_builders

torch.set_num_threads(2)

LARGE = dict(n_spheres=6, subdiv=2, max_chunk_tris=512, env_width=32)


def _numpy_builder(tri_verts, leaf_size=8, force_py=False):
    return build_bvh(tri_verts, leaf_size, force_py=True)


@pytest.fixture(scope="module")
def jax_large():
    """tpuray's make_large_scene with the numpy BVH builder forced (the
    native builder may order ties differently), as the port's below."""
    orig = jpart.build_bvh
    jpart.build_bvh = _numpy_builder
    try:
        return jmake_large_scene(**LARGE)
    finally:
        jpart.build_bvh = orig


@pytest.fixture(scope="module")
def large(jax_large):
    with port_numpy_builders():
        arrays = make_large_scene_arrays(**LARGE)
    scene = scene_from_numpy(arrays)
    return jax_large, arrays, scene, pack_traversal(scene)


def _geometry():
    return np.concatenate([
        icosphere(3), icosphere(2, radius=0.3, center=(1.2, 0.4, -0.6)),
        ground_quad()]).astype(np.float32)


@pytest.mark.parametrize("max_tris", [300, 10_000])
def test_forest_builders_match_jax(max_tris):
    tris = _geometry()
    parts = partition.partition_triangles(tris, max_tris)
    want = jpart.partition_triangles(tris, max_tris)
    assert len(parts) == len(want)
    for got, ref in zip(parts, want):
        np.testing.assert_array_equal(got, ref)
    for ours, theirs in ((partition.build_forest_bvh, jpart.build_forest_bvh),
                         (partition.build_forest_bvh_uniform,
                          jpart.build_forest_bvh_uniform)):
        got = ours(tris, 8, max_tris, force_py=True)
        ref = theirs(tris, 8, max_tris, force_py=True)
        assert set(got) == set(ref)
        for key in ref:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(ref[key]), err_msg=key)
    f = partition.build_forest_bvh_uniform(tris, 8, max_tris)
    np.testing.assert_array_equal(
        partition.apply_perm_padded(tris, f["perm"]),
        jpart.apply_perm_padded(tris, f["perm"]))


def test_make_large_scene_matches_jax(large):
    js, arrays, scene, tables = large
    ref = scene_to_numpy(js)
    assert set(arrays) == set(ref)
    for key, want in ref.items():
        if key == "envmap.cache":  # the JAX cache may be the native builder's
            continue
        np.testing.assert_array_equal(np.asarray(arrays[key], want.dtype),
                                      want, err_msg=key)
    assert (scene.bvh.chunk_nodes, scene.bvh.chunk_tris) == (
        js.bvh.chunk_nodes, js.bvh.chunk_tris)
    assert tables.n_chunks == js.bvh.n_chunks > 1
    assert (tables.chunk_nodes, tables.chunk_tris) == (js.bvh.chunk_nodes,
                                                       js.bvh.chunk_tris)


def _rays(seed, n, spread=5.0):
    rng = np.random.default_rng(seed)
    o = ((rng.random((n, 3)) - 0.5) * spread).astype(np.float32)
    tgt = ((rng.random((n, 3)) - 0.5) * 2.0).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("n", [1500, 777])
def test_k6_plain_matches_intersect_trace(large, n):
    js, _, _, tables = large
    o, d = _rays(n, n)
    dead = np.arange(n) % 3 == 0
    tm = np.where(dead, 0.0, 1e30).astype(np.float32)
    t_ref, i_ref = trace_xla(js.bvh, js.triangles, jnp.asarray(o),
                             jnp.asarray(d))
    t, i = ktc.trace_chunked(tables, torch.from_numpy(o), torch.from_numpy(d),
                             1e30)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    hit = np.asarray(i_ref) >= 0
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(t_ref)[hit], rtol=1e-5,
                               atol=1e-6)
    assert 0.2 < hit.mean() < 0.95
    # any-hit with dead lanes and a finite t_max (the point-shadow class)
    tm_p = np.where(dead, 0.0, 2.5).astype(np.float32)
    _, ia_ref = trace_xla(js.bvh, js.triangles, jnp.asarray(o), jnp.asarray(d),
                          t_max=jnp.asarray(tm_p), any_hit=True)
    _, ia = ktc.trace_chunked(tables, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(tm_p), any_hit=True)
    np.testing.assert_array_equal(ia.numpy() >= 0, np.asarray(ia_ref) >= 0)
    assert (ia.numpy()[dead] == -1).all()
    # closest hit with dead lanes
    t_d, i_d = ktc.trace_chunked(tables, torch.from_numpy(o),
                                 torch.from_numpy(d), torch.from_numpy(tm))
    assert (i_d.numpy()[dead] == -1).all() and (t_d.numpy()[dead] >= 1e29).all()
    np.testing.assert_array_equal(i_d.numpy()[~dead], np.asarray(i_ref)[~dead])


def test_k6_plain_common_origin_matches_intersect_trace(large):
    js, _, _, tables = large
    n = 1024
    o, d = _rays(3, n)
    o[:] = np.asarray([0.3, 0.9, 3.8], np.float32)
    d = np.asarray([0.0, -0.3, -1.0], np.float32) + 0.7 * (d - d.mean(0))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_ref, i_ref = trace_xla(js.bvh, js.triangles, jnp.asarray(o), jnp.asarray(d))
    t, i = ktc.trace_chunked(tables, torch.from_numpy(o[:1]),
                             torch.from_numpy(d), 1e30, common_origin=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    assert (np.asarray(i_ref) >= 0).mean() > 0.2


@pytest.fixture(scope="module")
def interp_chunked():
    """tpuray.kernels.trace_chunked with pallas_call in interpreter mode."""
    import importlib

    import tpuray.kernels.trace_chunked as tc
    orig_call = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig_call(*a, **k)

    pl.pallas_call = interp_call
    importlib.reload(tc)
    yield tc
    pl.pallas_call = orig_call
    importlib.reload(tc)


def test_k6_plain_matches_pallas_kernel(large, interp_chunked):
    js, _, _, tables = large
    n = 1500  # not a packet multiple
    o, d = _rays(9, n)
    tm = np.where(np.arange(n) % 4 == 0, 0.0, 1e30).astype(np.float32)
    t_ref, i_ref = interp_chunked.trace_chunked(
        js.bvh, js.triangles, jnp.asarray(o), jnp.asarray(d),
        t_max=jnp.asarray(tm))
    t, i = ktc.trace_chunked(tables, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(tm))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    hit = np.asarray(i_ref) >= 0
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(t_ref)[hit], rtol=1e-5,
                               atol=1e-6)
    _, ia_ref = interp_chunked.trace_chunked(
        js.bvh, js.triangles, jnp.asarray(o), jnp.asarray(d),
        t_max=jnp.asarray(tm), any_hit=True)
    _, ia = ktc.trace_chunked(tables, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(tm), any_hit=True)
    np.testing.assert_array_equal(ia.numpy() >= 0, np.asarray(ia_ref) >= 0)


def test_pack_forest_tables(large):
    """Global indices, the single-tree packing of every real node, and the
    padding the layout promises (inverted boxes, zero triangles)."""
    _, arrays, scene, tables = large
    cn, ct, c = tables.chunk_nodes, tables.chunk_tris, tables.n_chunks
    assert tables.n_nodes == c * cn and tables.n_tris == c * ct
    skip = arrays["bvh.skip"]
    count = arrays["bvh.tri_count"]
    inverted = (scene.bvh.aabb_min[:, 0] > scene.bvh.aabb_max[:, 0]).numpy()
    for k in range(c):
        root = k * cn
        # the root skips to the chunk's first padding row; padding rows are
        # inverted boxes that skip to the next chunk root
        pad = skip[root]
        assert root < pad <= root + cn
        assert inverted[pad: root + cn].all() and not inverted[root: pad].any()
        assert (skip[pad: root + cn] == root + cn).all()
        inner = np.flatnonzero(count[root: root + cn] == 0) + root
        real = inner[scene.bvh.aabb_min[inner, 0].numpy()
                     <= scene.bvh.aabb_max[inner, 0].numpy()]
        right = tables.meta[2].numpy()[real]
        assert ((right > real + 1) & (right < root + cn)).all()
    padding_tri = (arrays["triangles.p0"] == 0).all(-1) & (
        arrays["triangles.p1"] == 0).all(-1)
    assert padding_tri.any()
    assert (tables.tverts[:, torch.from_numpy(padding_tri)] == 0).all()


def test_stats_skip_padding_nodes(large):
    """The work count (bound_ms) counts box tests on real nodes only; the
    plain wavefront also steps through every padding node of an entered
    chunk."""
    _, _, scene, tables = large
    o, d = _rays(4, 512)
    stats = {}
    ktc.trace_chunked_plain(tables, torch.from_numpy(o), torch.from_numpy(d),
                            1e30, stats=stats)
    all_boxes = {}
    inverted = tables.aabb[0] > tables.aabb[3]
    assert bool(inverted.any())
    fake = dataclasses.replace(tables, aabb=torch.where(
        inverted[None], 0.0, tables.aabb))
    # same walk with the padding boxes made real (all-zero): more box tests
    ktc.trace_chunked_plain(fake, torch.from_numpy(o), torch.from_numpy(d),
                            1e30, stats=all_boxes)
    assert all_boxes["box_tests"] > stats["box_tests"] > 0
    assert stats["tri_tests"] > 0


def test_pack_forest_rejects_bad_forests(large):
    _, _, scene, _ = large
    with pytest.raises(ValueError, match="single tree"):
        kt.pack_scene(scene.bvh, scene.triangles)
    single = scene_from_numpy(
        {k: v for k, v in make_large_scene_arrays(**LARGE).items()
         if not k.startswith("bvh.chunk")})
    with pytest.raises(ValueError, match="chunked forest"):
        ktc.pack_forest(single.bvh, single.triangles)
    # a chunk whose tree is a 130-deep chain: no stack fits it
    n = 2 * 130 + 1
    cn = 384
    skip = np.full(cn, cn, np.int32)
    count = np.zeros(cn, np.int32)
    for k in range(130):  # inner node 2k: left child 2k+1 (leaf), right 2k+2
        skip[2 * k + 1] = 2 * k + 2
    skip[0:n:2] = n
    skip[0] = cn
    count[1:n:2] = 1
    count[n - 1] = 1
    with pytest.raises(ValueError, match="stack"):
        ktc._check_forest(skip, count, cn)
    # a tree that points outside its chunk's rows
    bad = skip.copy()
    bad[1] = cn + 5  # node 0's right child
    with pytest.raises(ValueError, match="chunk 0"):
        ktc._check_forest(bad, count, cn)


def test_cpu_path_counts_no_launch(large):
    _, _, _, tables = large
    o, d = _rays(5, 64)
    ktc.reset_launches()
    ktc.trace_chunked(tables, torch.from_numpy(o), torch.from_numpy(d), 1e30)
    assert ktc.LAUNCHES == {"k6": 0}
    meta_d = torch.empty((64, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ktc.trace_chunked(tables, meta_d, meta_d, 1e30)


def test_forest_walk_matches_bruteforce(large):
    """The forest's skip links reach every chunk: the closest hit equals the
    O(rays x triangles) oracle."""
    _, _, scene, tables = large
    o, d = _rays(6, 200)
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    t, i = ktc.trace_chunked(tables, o_t, d_t, 1e30)
    t_b, i_b = intersect.trace_bruteforce(scene.triangles, o_t, d_t)
    torch.testing.assert_close(t, t_b, rtol=0, atol=0)
    assert torch.equal(i >= 0, i_b >= 0)
