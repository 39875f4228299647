"""K3's 4-wide records (kernels/trace.py:wide_tree; layout and walk in
csrc/trace_wide.cu), checked on the CPU where no kernel runs.

- Every triangle is reached from exactly one leaf ref, and every wide row
  from exactly one parent, on make_test_scene(subdiv=2).
- Each child box is the box of a binary node, bit for bit, and contains
  its triangles and the child boxes below it in f32.
- The pack-time stack check raises on a tree whose walk could overflow
  WIDE_STACK, and its count bounds the deepest stack a walk reaches.
- A numpy copy of the kernel's walk (children sorted by slab entry
  distance with the same five exchanges, leaf children scanned nearest
  first while they lie before the best hit, the nearest inner child next,
  the others pushed far-first with their entry distance, a pop skipping an
  entry no longer before the best hit) gives trace_packets_plain's
  (t, idx) on seeded rays with origins inside boxes and dead lanes: t bit
  for bit, idx equal but for exact-t ties (the visiting order decides a
  tie), any-hit hit/miss equal. numpy float32 repeats the kernel's float
  ops in the same order with no contraction, as -fmad=false does on the
  card.

The JAX package's _kernel_batched is held against the plain version by
tests/test_torch_trace_kernels.py; the kernel itself against the plain
version on the card by tests/test_torch_gpu.py."""
import dataclasses

import numpy as np
import pytest
import torch

from tpuray.scene.procedural import make_test_scene as jmake_test_scene

from tpuray_torch.kernels import trace as kt
from tpuray_torch.scene.types import BVHSoA, scene_from_numpy, scene_to_numpy

from tests.test_torch_trace_records import _assert_closest, _decode, _rays, _safe_inv, _tri_test

torch.set_num_threads(2)

F32 = np.float32
INF = F32(np.inf)


@pytest.fixture(scope="module")
def single():
    scene = scene_from_numpy(scene_to_numpy(jmake_test_scene(subdiv=2, env_width=32)))
    return scene, kt.pack_scene(scene.bvh, scene.triangles)


def _bounds(records):
    """(R4, 6, WIDE) f32: min x, max x, min y, max y, min z, max z of each child."""
    return records[:, :6 * kt.WIDE].view(F32).reshape(-1, 6, kt.WIDE)


def _refs(records):
    return records[:, 6 * kt.WIDE:7 * kt.WIDE].astype(np.int64)


def test_every_triangle_and_row_reached_once(single):
    _, tables = single
    wide = tables.wide.numpy()
    assert wide.shape == (wide.shape[0], 8 * kt.WIDE) and tables.wide_root == 0
    assert (wide[:, 7 * kt.WIDE:] == 0).all()
    refs = _refs(wide)
    inner = np.sort(refs[refs >= 0])
    np.testing.assert_array_equal(inner, np.arange(1, wide.shape[0]))
    first, count = _decode(refs[(refs < 0) & (refs != kt.WIDE_EMPTY)])
    assert (count >= 1).all() and (count <= kt.MAX_LEAF).all()
    reached = np.zeros(tables.n_tris, np.int64)
    for f, c in zip(first, count):
        reached[f:f + c] += 1
    np.testing.assert_array_equal(reached, 1)
    # about half the binary inner nodes: a walk makes about half the visits
    n_inner = int((tables.meta[1] == 0).sum())
    assert wide.shape[0] <= 0.6 * n_inner


def test_child_boxes_are_binary_boxes_and_nest(single):
    scene, tables = single
    wide = tables.wide.numpy()
    b, refs = _bounds(wide), _refs(wide)
    aabb = tables.aabb.numpy()
    binary = {tuple(aabb[[0, 3, 1, 4, 2, 5], i].view(np.int32)) for i in range(tables.n_nodes)}
    empty = refs == kt.WIDE_EMPTY
    assert (b.transpose(0, 2, 1)[empty] == INF).all()
    for r, k in zip(*np.nonzero(~empty)):
        box = b[r, :, k]
        assert tuple(box.view(np.int32)) in binary
        lo, hi = box[0::2], box[1::2]
        ref = refs[r, k]
        if ref >= 0:  # the child boxes below lie inside it
            below = b[ref].transpose(1, 0)[refs[ref] != kt.WIDE_EMPTY]
            assert (below[:, 0::2] >= lo).all() and (below[:, 1::2] <= hi).all()
        else:  # its triangles lie inside it
            (f,), (c,) = _decode([ref])
            v = np.stack([x.numpy()[f:f + c] for x in
                          (scene.triangles.p0, scene.triangles.p1, scene.triangles.p2)])
            assert (v >= lo).all() and (v <= hi).all()


def _caterpillar(length: int):
    """A binary tree of `length` levels: inner node A_k has an inner child
    B_k (two one-triangle leaves, a small box) and A_{k+1} (a box that
    shrinks with k), so each wide node takes three B's and one A, four
    inner children, and every wide level adds three pending entries."""
    meta, boxes = [], []

    def add(count, first, box):
        meta.append([first, count, 0, 0, 0])
        boxes.append(box)
        return len(meta) - 1

    tri = 0

    def a_node(k):
        nonlocal tri
        size = float(length - k + 2)
        i = add(0, 0, (0, 0, 0, size, size, size))
        if k == length:
            meta[i][:2] = [tri, 1]
            tri += 1
            return i
        b = add(0, 0, (0, 0, 0, 0.1, 0.1, 0.1))
        add(1, tri, (0, 0, 0, 0.1, 0.1, 0.1))
        meta[b][2] = add(1, tri + 1, (0, 0, 0, 0.1, 0.1, 0.1))
        tri += 2
        meta[i][2] = a_node(k + 1)
        return i

    a_node(0)
    meta = np.asarray(meta, np.int64).T.astype(np.int32)
    aabb = np.asarray(boxes, F32).T.copy()
    return meta, aabb


def test_stack_check_raises_on_a_deep_tree():
    """Each wide level of the caterpillar pushes three entries: 15 binary
    levels need 14, 90 need 89 > WIDE_STACK (a depth that the binary
    kernels' stack of MAX_STACK still takes)."""
    assert kt.wide_tree(*_caterpillar(15)).stack == 14
    assert kt.wide_tree(*_caterpillar(60)).stack == 59
    with pytest.raises(ValueError, match="stack of 89 > WIDE_STACK"):
        kt.wide_tree(*_caterpillar(90))


def test_leaf_root_packs_no_records():
    """A tree that is one leaf: K3's root is the leaf's ref."""
    meta = np.asarray([[3], [5], [0], [0], [0]], np.int32)
    aabb = np.asarray([[0], [0], [0], [1], [1], [1]], F32)
    w = kt.wide_tree(meta, aabb)
    assert w.records.shape == (0, 8 * kt.WIDE) and w.root == kt.leaf_ref(3, 5)
    assert w.stack == 0


def _slab_t0(b, k, o, inv, limit):
    """csrc/trace_common.cuh:slab_t0 on child k of the records b (n, 6, WIDE)."""
    lox, hix, loy, hiy, loz, hiz = (b[:, j, k] for j in range(6))
    f0, n0 = (hix - o[:, 0]) * inv[:, 0], (lox - o[:, 0]) * inv[:, 0]
    f1, n1 = (hiy - o[:, 1]) * inv[:, 1], (loy - o[:, 1]) * inv[:, 1]
    f2, n2 = (hiz - o[:, 2]) * inv[:, 2], (loz - o[:, 2]) * inv[:, 2]
    t1 = np.minimum(np.maximum(f0, n0), np.minimum(np.maximum(f1, n1), np.maximum(f2, n2)))
    t0 = np.maximum(np.minimum(f0, n0), np.maximum(np.minimum(f1, n1), np.minimum(f2, n2)))
    hit = (t1 >= np.maximum(t0, F32(0))) & (t0 < limit) & (t1 > F32(0))
    return np.where(hit, t0, INF)


def _exchange(key, child, a, b):
    s = key[:, b] < key[:, a]
    ka, kb, ra, rb = key[:, a].copy(), key[:, b].copy(), child[:, a].copy(), child[:, b].copy()
    key[:, a], key[:, b] = np.where(s, kb, ka), np.where(s, ka, kb)
    child[:, a], child[:, b] = np.where(s, rb, ra), np.where(s, ra, rb)


def wide_walk(tables, o, d, tm, any_hit=False):
    """trace_k3 for every ray at once: each step visits one wide node per
    ray that is still walking. Returns (t, idx, deepest stack)."""
    wide = tables.wide.numpy()
    bounds, refs = _bounds(wide), _refs(wide)
    tris = tables.tris.numpy()
    n = d.shape[0]
    inv = _safe_inv(d)
    t = np.full(n, F32(1e30))
    idx = np.full(n, -1, np.int64)
    st_ref = np.zeros((n, kt.WIDE_STACK), np.int64)
    st_t0 = np.zeros((n, kt.WIDE_STACK), F32)
    sp = np.zeros(n, np.int64)
    node = np.full(n, -1, np.int64)

    def scan(rows, leaf):
        first, count = _decode(leaf)
        for j in range(kt.MAX_LEAF):
            m = j < count
            if any_hit:
                m &= idx[rows] < 0
            r, ti = rows[m], first[m] + j
            hit, th = _tri_test(tris[ti], o[r], d[r])
            upd = hit & (th < t[r]) & (th < tm[r])
            t[r[upd]], idx[r[upd]] = th[upd], ti[upd]

    b = tables.root_box.numpy()
    rb = np.asarray([b[0], b[3], b[1], b[4], b[2], b[5]], F32)[None, :, None]
    live = (tm > 0) & (_slab_t0(np.broadcast_to(rb, (n, 6, 1)), 0, o, inv, tm) < INF)
    live = np.flatnonzero(live)
    if tables.wide_root < 0:
        scan(live, np.full(live.size, tables.wide_root))
        return t, idx, 0
    node[live] = tables.wide_root
    deepest = 0
    while True:
        rows = np.flatnonzero(node >= 0)
        if rows.size == 0:
            return t, idx, deepest
        nd = node[rows]
        limit = np.minimum(t[rows], tm[rows])
        key = np.stack([_slab_t0(bounds[nd], k, o[rows], inv[rows], limit)
                        for k in range(kt.WIDE)], 1)
        child = refs[nd].copy()
        for a, c in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
            _exchange(key, child, a, c)
        for k in range(kt.WIDE):
            m = (child[:, k] < 0) & (key[:, k] < np.minimum(t[rows], tm[rows]))
            if any_hit:
                m &= idx[rows] < 0
            scan(rows[m], child[m, k])
        nxt = np.full(rows.size, -1, np.int64)
        nxt_t0 = np.zeros(rows.size, F32)
        for k in range(kt.WIDE - 1, -1, -1):
            m = (child[:, k] >= 0) & (key[:, k] < np.minimum(t[rows], tm[rows]))
            push = m & (nxt >= 0)
            r = rows[push]
            st_ref[r, sp[r]], st_t0[r, sp[r]] = nxt[push], nxt_t0[push]
            sp[r] += 1
            nxt = np.where(m, child[:, k], nxt)
            nxt_t0 = np.where(m, key[:, k], nxt_t0)
        deepest = max(deepest, int(sp.max()))
        while True:
            m = (nxt < 0) & (sp[rows] > 0)
            if not m.any():
                break
            r = rows[m]
            sp[r] -= 1
            ok = st_t0[r, sp[r]] < np.minimum(t[r], tm[r])
            nxt[np.flatnonzero(m)[ok]] = st_ref[r[ok], sp[r[ok]]]
        if any_hit:
            nxt = np.where(idx[rows] >= 0, -1, nxt)
        node[rows] = nxt


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_wide_walk_matches_plain(single, any_hit, seed):
    """K3's walk over the wide records against trace_packets_plain, which
    walks the SoA rows by skip links, on per-ray origins (an eighth at the
    origin, inside the sphere's boxes), dead lanes and, for any-hit, a
    finite t_max."""
    _, tables = single
    n = 1024
    o, d = _rays(seed, n, [0.0, 0.3, 2.0], 1.5, False)
    dead = np.arange(n) % 5 == 0
    tm = np.where(dead, 0.0, 2.5 if any_hit else 1e30).astype(F32)
    t_ref, i_ref = kt.trace_packets_plain(tables, torch.from_numpy(o), torch.from_numpy(d),
                                          torch.from_numpy(tm), any_hit)
    t, i, deepest = wide_walk(tables, o, d, tm, any_hit)
    i_ref = i_ref.numpy()
    if any_hit:
        np.testing.assert_array_equal(i >= 0, i_ref >= 0)
    else:
        _assert_closest(t, i, t_ref.numpy(), i_ref)
    assert (i[dead] == -1).all()
    assert 0.1 < (i_ref >= 0).mean() < 0.95
    assert 0 < deepest <= kt.wide_tree(tables.meta.numpy(), tables.aabb.numpy()).stack


def test_wide_walk_on_a_leaf_root(single):
    """A scene of at most MAX_LEAF triangles: the root is a leaf."""
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
    assert tables.wide_root == kt.leaf_ref(0, tri_n) and tables.wide.shape[0] == 0
    n = 256
    o, d = _rays(5, n, [0.0, 0.3, 2.0], 1.5, False)
    centroid = (v.mean(0).numpy()[np.arange(n) % tri_n] - o).astype(F32)
    d[::2] = (centroid / np.linalg.norm(centroid, axis=-1, keepdims=True))[::2]
    tm = np.full(n, F32(1e30))
    t_ref, i_ref = kt.trace_packets_plain(tables, torch.from_numpy(o), torch.from_numpy(d),
                                          torch.from_numpy(tm))
    t, i, _ = wide_walk(tables, o, d, tm)
    _assert_closest(t, i, t_ref.numpy(), i_ref.numpy())
    assert (i >= 0).sum() >= n // 4
