"""tpuray_torch.integrator.intersect (the plain traversal K1/K2 are held
against) vs tpuray.integrator.intersect on the CPU, same scene, same rays.

Tolerances: idx exact; t within rtol 1e-6 (the op order is the JAX
package's, so t differs by at most float32 rounding of the constants);
any-hit rays compare hit/miss only (which triangle is found first is
walk-order dependent)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuray.integrator import intersect as jint
from tpuray.scene.procedural import make_test_scene

from tpuray_torch.integrator import intersect
from tpuray_torch.scene.types import scene_from_numpy, scene_to_numpy

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scenes():
    js = make_test_scene(subdiv=2, env_width=32)
    return js, scene_from_numpy(scene_to_numpy(js))


def make_rays(seed, n):
    rng = np.random.default_rng(seed)
    o = np.tile(np.asarray([[0.0, 0.3, 2.0]], np.float32), (n, 1))
    o += (rng.random((n, 3)).astype(np.float32) - 0.5) * 0.4
    tgt = (rng.random((n, 3)).astype(np.float32) - 0.5) * 1.5
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_triangle_constants_match(scenes):
    js, ts = scenes
    want = jint.triangle_constants(js.triangles)
    got = intersect.triangle_constants(ts.triangles)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_trace_closest_hit_matches(scenes):
    js, ts = scenes
    o, d = make_rays(0, 2048)
    t_ref, i_ref = jint.trace(js.bvh, js.triangles, jnp.asarray(o), jnp.asarray(d))
    t, i = intersect.trace(ts.bvh, ts.triangles, torch.from_numpy(o),
                           torch.from_numpy(d))
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    m = np.asarray(i_ref) >= 0
    assert m.mean() > 0.3
    np.testing.assert_allclose(t.numpy()[m], np.asarray(t_ref)[m], rtol=1e-6)
    assert (t.numpy()[~m] == np.float32(1e30)).all()


def test_trace_any_hit_matches(scenes):
    js, ts = scenes
    o, d = make_rays(1, 2048)
    tm = np.full((2048,), 1.5, np.float32)
    _, i_ref = jint.trace(js.bvh, js.triangles, jnp.asarray(o), jnp.asarray(d),
                          t_max=jnp.asarray(tm), any_hit=True)
    _, i = intersect.trace(ts.bvh, ts.triangles, torch.from_numpy(o),
                           torch.from_numpy(d), t_max=torch.from_numpy(tm),
                           any_hit=True)
    np.testing.assert_array_equal(i.numpy() >= 0, np.asarray(i_ref) >= 0)


def test_dead_lanes_inert(scenes):
    """t_max <= 0 marks a lane dead, even with its origin inside the scene."""
    js, ts = scenes
    n = 2048
    o, d = make_rays(2, n)
    o[: n // 2] = 0.0
    dead = np.arange(n) % 3 == 0
    tm = np.where(dead, 0.0, 1e30).astype(np.float32)
    t, i = intersect.trace(ts.bvh, ts.triangles, torch.from_numpy(o),
                           torch.from_numpy(d), t_max=torch.from_numpy(tm))
    t_ref, i_ref = jint.trace(js.bvh, js.triangles, jnp.asarray(o),
                              jnp.asarray(d), t_max=jnp.asarray(tm))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    assert (i.numpy()[dead] == -1).all() and (t.numpy()[dead] >= 1e29).all()
    _, ia = intersect.trace(ts.bvh, ts.triangles, torch.from_numpy(o),
                            torch.from_numpy(d), t_max=torch.from_numpy(tm),
                            any_hit=True)
    assert (ia.numpy()[dead] == -1).all()
    _, i_full = intersect.trace(ts.bvh, ts.triangles, torch.from_numpy(o),
                                torch.from_numpy(d))
    np.testing.assert_array_equal(i.numpy()[~dead], i_full.numpy()[~dead])


def test_trace_bruteforce_matches(scenes):
    js, ts = scenes
    o, d = make_rays(3, 256)
    t_ref, i_ref = jint.trace_bruteforce(js.triangles, jnp.asarray(o), jnp.asarray(d))
    t, i = intersect.trace_bruteforce(ts.triangles, torch.from_numpy(o),
                                      torch.from_numpy(d))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    m = np.asarray(i_ref) >= 0
    np.testing.assert_allclose(t.numpy()[m], np.asarray(t_ref)[m], rtol=1e-6)
    # and the BVH walk finds the brute-force answer
    _, i_bvh = intersect.trace(ts.bvh, ts.triangles, torch.from_numpy(o),
                               torch.from_numpy(d))
    np.testing.assert_array_equal(i_bvh.numpy(), i.numpy())


@pytest.mark.parametrize("quirks", [False, True])
def test_barycentrics_match(quirks):
    rng = np.random.default_rng(4)
    p0, p1, p2 = (rng.random((512, 3)).astype(np.float32) for _ in range(3))
    w = rng.random((512, 3)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    p = w[:, :1] * p0 + w[:, 1:2] * p1 + w[:, 2:] * p2
    got = intersect.barycentrics(*map(torch.from_numpy, (p, p0, p1, p2)),
                                 reference_quirks=quirks)
    want = jint.barycentrics(*map(jnp.asarray, (p, p0, p1, p2)),
                             reference_quirks=quirks)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)
