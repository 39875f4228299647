"""K1's warp walk over the 4-wide records (csrc/trace_wide.cu:walk_warp),
checked on the CPU where no kernel runs.

A numpy copy of the kernel runs 32-lane warps side by side, each an 8x4
patch of a block's four 32-ray rows (patch_rays). Each warp visits one
node at a time (the union of its lanes' paths); each lane slab-tests the
four children against its own limit min(t, t_max) (minus infinity once
it is dead or, any-hit, has its hit); a child's warp key is the least
max(t0, 0) over its lanes as float bits; the children are sorted by
those keys with K3's five exchanges; a leaf child is scanned four
triangles at a time by the lanes whose own key still lies before their
best hit; the nearest inner child that a lane still enters is next and
the others go onto one warp-uniform stack far-first; a pop skips an entry
whose key is not below the largest limit of an active lane. numpy
float32 repeats the kernel's float ops in the same order with no
contraction, as -fmad=false does on the card.

On make_test_scene(subdiv=2) it gives trace_packets_plain's (t, idx): t
bit for bit, idx equal but for exact-t ties (the visiting order decides a
tie), any-hit hit/miss equal, on three ray sets from one origin with dead
lanes: the 64x64 camera primaries in 32x32 tile order (camera_rays),
random directions from an origin outside the root box, and from one
inside it; and on a tree whose root is a leaf.

The JAX package's _kernel is held against the plain version by
tests/test_torch_trace_kernels.py; the kernel itself against the plain
version on the card by tests/test_torch_gpu.py."""
import dataclasses

import numpy as np
import pytest
import torch

from tpuray.scene.procedural import make_test_scene as jmake_test_scene

from tpuray_torch.kernels import trace as kt
from tpuray_torch.render.renderer import camera_rays
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.types import BVHSoA, scene_from_numpy, scene_to_numpy

from tests.test_torch_trace_records import _assert_closest, _decode, _safe_inv, _tri_test
from tests.test_torch_trace_wide import _bounds, _refs, _slab_t0

torch.set_num_threads(2)

F32 = np.float32
INF = F32(np.inf)
INF_BITS = np.uint32(0x7F800000)
LANES = 32
BLOCK = 128  # csrc/trace_common.cuh:kBlock


@pytest.fixture(scope="module")
def single():
    scene = scene_from_numpy(scene_to_numpy(jmake_test_scene(subdiv=2, env_width=32)))
    return scene, kt.pack_scene(scene.bvh, scene.triangles)


def _order_bits(key):
    """walk_warp's order key: the bits of max(t0, 0); +inf stays +inf."""
    return np.where(key > 0, key, F32(0)).astype(F32).view(np.uint32)


def patch_rays(n):
    """trace_k1_warp's patch_ray: the ray of each thread of ceil(n / 128)
    blocks of 128, in thread order; warp w of a block takes columns
    8w..8w+7 of its four 32-ray rows. A ray >= n is a dead lane's."""
    tid = np.arange(BLOCK)
    local = (tid % LANES) // 8 * LANES + (tid // LANES) * 8 + tid % 8
    return (np.arange(-(-n // BLOCK))[:, None] * BLOCK + local).reshape(-1)


def warp_walk(tables, o, d, tm, any_hit=False):
    """trace_k1_warp for every warp at once: rays (n, 3) from the one origin
    o (3,), in warps of 32 lanes (patch_rays); each step visits one node
    per warp that is still walking. Returns (t, idx, stats) with
    stats: node visits, lane-visits whose lane entered no child, deepest
    stack."""
    wide = tables.wide.numpy()
    bounds, refs = _bounds(wide), _refs(wide)
    tris = tables.tris.numpy()
    n = d.shape[0]
    ray = patch_rays(n)  # the ray of each thread, in thread order
    w = ray.size // LANES
    valid = ray < n
    dl = np.where(valid[:, None], d[np.minimum(ray, n - 1)], F32(0)).reshape(w, LANES, 3)
    tml = np.where(valid, tm[np.minimum(ray, n - 1)], F32(0)).reshape(w, LANES)
    ol = np.broadcast_to(np.asarray(o, F32), (w, LANES, 3))
    inv = _safe_inv(dl)
    t = np.full((w, LANES), F32(1e30))
    idx = np.full((w, LANES), -1, np.int64)
    stats = dict(visits=0, idle_lane_visits=0, deepest=0)

    def flat(x):
        return x.reshape((-1,) + x.shape[2:])

    def unpatch(x):
        out = np.empty(n, x.dtype)
        out[ray[valid]] = x.reshape(-1)[valid]
        return out

    def slab_keys(rows, box, lim):
        """Each lane's slab key of each of the 4 children of box (r, 6, 4)."""
        b = np.repeat(box, LANES, axis=0)
        return np.stack([_slab_t0(b, k, flat(ol[rows]), flat(inv[rows]), flat(lim))
                         for k in range(kt.WIDE)], 1).reshape(len(rows), LANES, kt.WIDE)

    def limit(rows):
        act = live[rows] & ~(any_hit & (idx[rows] >= 0))
        return np.where(act, np.minimum(t[rows], tml[rows]), -INF)

    def scan(rows, leaf, mine):
        """scan_warp: leaf (r,) refs, mine (r, 32); four triangles a step,
        all tested before any update, updates in the triangles' order."""
        first, count = _decode(leaf)
        mine = mine.copy()
        for j in range(0, kt.MAX_LEAF, 4):
            go = j < count
            r, m = rows[go], mine[go]
            got = np.zeros(m.shape, bool)
            tests = []
            for k in range(4):
                has = (j + k < count[go])[:, None]
                ti = first[go] + np.where(j + k < count[go], j + k, j)
                hit, th = _tri_test(np.repeat(tris[ti], LANES, 0), flat(ol[r]), flat(dl[r]))
                tests.append((hit.reshape(-1, LANES) & has & m, th.reshape(-1, LANES),
                              first[go] + j + k))
            tr, ir = t[r], idx[r]
            for hit, th, ti in tests:
                u = hit & ~(any_hit & got) & (th < tr) & (th < tml[r])
                tr, ir = np.where(u, th, tr), np.where(u, ti[:, None], ir)
                got |= u
            t[r], idx[r] = tr, ir
            if any_hit:
                mine[go] = m & (ir < 0)

    b = tables.root_box.numpy()
    rb = np.asarray([b[0], b[3], b[1], b[4], b[2], b[5]], F32)[None, :, None]
    live = (tml > 0) & (_slab_t0(np.broadcast_to(rb, (w * LANES, 6, 1)), 0, flat(ol),
                                 flat(inv), flat(tml)) < INF).reshape(w, LANES)
    walking = np.flatnonzero(live.any(1))
    if tables.wide_root < 0:
        scan(walking, np.full(walking.size, tables.wide_root), live[walking])
        return unpatch(t), unpatch(idx), stats
    node = np.full(w, -1, np.int64)
    node[walking] = tables.wide_root
    st_ref = np.zeros((w, kt.WIDE_STACK), np.int64)
    st_key = np.zeros((w, kt.WIDE_STACK), np.uint32)
    sp = np.zeros(w, np.int64)
    while True:
        rows = np.flatnonzero(node >= 0)
        if rows.size == 0:
            return unpatch(t), unpatch(idx), stats
        nd = node[rows]
        lim = limit(rows)
        key = slab_keys(rows, bounds[nd], lim)  # (r, 32, 4)
        child = refs[nd].copy()
        wk = _order_bits(key).min(1)  # (r, 4)
        stats["visits"] += rows.size
        stats["idle_lane_visits"] += int(((key == INF).all(2) & (lim > -INF)).sum())
        for a, c in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
            s = wk[:, c] < wk[:, a]
            wk[:, [a, c]] = np.where(s[:, None], wk[:, [c, a]], wk[:, [a, c]])
            child[:, [a, c]] = np.where(s[:, None], child[:, [c, a]], child[:, [a, c]])
            key[:, :, [a, c]] = np.where(s[:, None, None], key[:, :, [c, a]],
                                         key[:, :, [a, c]])
        for k in range(kt.WIDE):
            mine = key[:, :, k] < limit(rows)
            go = (child[:, k] < 0) & (wk[:, k] != INF_BITS) & mine.any(1)
            scan(rows[go], child[go, k], mine[go])
        lim2 = limit(rows)
        nxt = np.full(rows.size, -1, np.int64)
        nxt_key = np.zeros(rows.size, np.uint32)
        for k in range(kt.WIDE - 1, -1, -1):
            m = ((child[:, k] >= 0) & (wk[:, k] != INF_BITS)
                 & (key[:, :, k] < lim2).any(1))
            push = rows[m & (nxt >= 0)]
            pm = m & (nxt >= 0)
            st_ref[push, sp[push]], st_key[push, sp[push]] = nxt[pm], nxt_key[pm]
            sp[push] += 1
            nxt = np.where(m, child[:, k], nxt)
            nxt_key = np.where(m, wk[:, k], nxt_key)
        stats["deepest"] = max(stats["deepest"], int(sp.max()))
        lim_max = np.where(lim2 > -INF, lim2, F32(0)).astype(F32).view(np.uint32).max(1)
        while True:
            m = (nxt < 0) & (sp[rows] > 0)
            if not m.any():
                break
            r = rows[m]
            sp[r] -= 1
            ok = st_key[r, sp[r]] < lim_max[m]
            nxt[np.flatnonzero(m)[ok]] = st_ref[r[ok], sp[r[ok]]]
        node[rows] = nxt


def _from_one_origin(seed, n, origin, spread):
    """n unit directions from `origin` toward random points of a box of
    side `spread` about the sphere."""
    rng = np.random.default_rng(seed)
    o = np.asarray(origin, F32)
    d = ((rng.random((n, 3)) - 0.5) * spread).astype(F32) - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(F32)


def _primaries(size):
    cam = OrbitCamera(width=size, height=size).snapshot("cpu")
    orig, d, _, _ = camera_rays(cam, size, size)
    return orig[0].numpy(), d.numpy()


# name: (rays(n), an any-hit t_max that reaches the geometry)
RAY_SETS = {
    "camera primaries": (lambda n: (_primaries(64)[0], _primaries(64)[1][:n]), 2.5),
    "origin outside the root box": (
        lambda n: _from_one_origin(7, n, [0.5, 2.0, 6.0], 2.0), 8.0),
    "origin inside the root box": (
        lambda n: _from_one_origin(8, n, [0.3, 0.2, 1.2], 3.0), 2.5),
}


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("rays", list(RAY_SETS))
def test_warp_walk_matches_plain(single, rays, any_hit):
    """The warp walk against trace_packets_plain, which walks the SoA rows
    by skip links, with a dead lane in every 7 and, for any-hit, a finite
    t_max; n is not a multiple of 32 (the last warp has lanes past n)."""
    _, tables = single
    make, shadow = RAY_SETS[rays]
    o, d = make(4096 - 5)
    n = d.shape[0]
    dead = np.arange(n) % 7 == 3
    tm = np.where(dead, 0.0, shadow if any_hit else 1e30).astype(F32)
    t_ref, i_ref = kt.trace_packets_plain(tables, torch.from_numpy(o[None]),
                                          torch.from_numpy(d), torch.from_numpy(tm),
                                          any_hit, common_origin=True)
    t, i, stats = warp_walk(tables, o, d, tm, any_hit)
    i_ref = i_ref.numpy()
    if any_hit:
        np.testing.assert_array_equal(i >= 0, i_ref >= 0)
    else:
        _assert_closest(t, i, t_ref.numpy(), i_ref)
    assert (i[dead] == -1).all() and (t[dead] == F32(1e30)).all()
    assert 0.1 < (i_ref >= 0).mean() < 0.95
    assert 0 < stats["deepest"] <= kt.wide_tree(tables.meta.numpy(),
                                                tables.aabb.numpy()).stack
    if rays != "camera primaries":  # the union walk: lanes visit nodes they do not enter
        assert stats["idle_lane_visits"] > 0


def test_warp_walk_scalar_and_tensor_t_max_agree(single):
    """The frame's primaries pass t_max as a float: the kernel reads one
    argument, and the plain version fills it in; both equal a per-ray
    t_max of the same value."""
    _, tables = single
    o, d = _primaries(64)
    n = d.shape[0]
    tm = np.full(n, F32(1e30))
    t_s, i_s = kt.trace_packets_plain(tables, torch.from_numpy(o[None]), torch.from_numpy(d),
                                      1e30, common_origin=True)
    t_a, i_a = kt.trace_packets_plain(tables, torch.from_numpy(o[None]), torch.from_numpy(d),
                                      torch.from_numpy(tm), common_origin=True)
    assert torch.equal(t_s, t_a) and torch.equal(i_s, i_a)
    t, i, _ = warp_walk(tables, o, d, tm)
    _assert_closest(t, i, t_s.numpy(), i_s.numpy())


def test_warp_walk_on_a_leaf_root(single):
    """A scene of at most MAX_LEAF triangles: the root is a leaf, which the
    warp scans at once."""
    scene, _ = single
    tri_n = 6
    tri = scene.triangles.replace(**{f.name: getattr(scene.triangles, f.name)[:tri_n]
                                     for f in dataclasses.fields(scene.triangles)})
    v = torch.stack([tri.p0, tri.p1, tri.p2])
    bvh = BVHSoA(aabb_min=v.amin((0, 1))[None], aabb_max=v.amax((0, 1))[None],
                 first_tri=torch.zeros(1, dtype=torch.int32),
                 tri_count=torch.full((1,), tri_n, dtype=torch.int32),
                 skip=torch.ones(1, dtype=torch.int32))
    tables = kt.pack_scene(bvh, tri)
    assert tables.wide_root == kt.leaf_ref(0, tri_n)
    n = 256 + 9
    o = np.asarray([0.0, 0.3, 2.0], F32)
    centroid = (v.mean(0).numpy()[np.arange(n) % tri_n] - o).astype(F32)
    d = (centroid / np.linalg.norm(centroid, axis=-1, keepdims=True)).astype(F32)
    d[1::2] = _from_one_origin(9, n, o, 1.5)[1][1::2]
    tm = np.where(np.arange(n) % 5 == 0, 0.0, 1e30).astype(F32)
    for any_hit in (False, True):
        t_ref, i_ref = kt.trace_packets_plain(tables, torch.from_numpy(o[None]),
                                              torch.from_numpy(d), torch.from_numpy(tm),
                                              any_hit, common_origin=True)
        t, i, _ = warp_walk(tables, o, d, tm, any_hit)
        if any_hit:
            np.testing.assert_array_equal(i >= 0, i_ref.numpy() >= 0)
        else:
            _assert_closest(t, i, t_ref.numpy(), i_ref.numpy())
        assert (i >= 0).sum() >= n // 4
