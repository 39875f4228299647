"""The traversal kernels' packed records (kernels/trace.py:node_records,
kernels/trace_chunked.py:top_level_tree; layout in
csrc/trace_common.cuh), checked on the CPU where no kernel runs.

- The node and triangle records unpack to the SoA tables exactly, on
  make_test_scene(subdiv=2) and a small make_large_scene (4 chunks).
- A numpy DFS over the records, the kernels' walk written out
  (walk_subtree: root box, near-first children, leaf children scanned when
  entered, limit min(t, t_max); a forest from its top-level root), gives
  the plain versions' (t, idx) on seeded rays: t bit-equal, idx equal but
  for exact-t ties (the visiting order decides a tie), any-hit hit/miss
  equal. numpy float32 repeats the kernels' float ops in the same order
  with no contraction, as -fmad=false does on the card.
- The top-level tree reaches every chunk root exactly once and its boxes
  contain the boxes below them; pack_forest's combined-depth check raises.

The JAX package's pack_scene and forest layout are held against these
tables' SoA rows by tests/test_torch_trace_kernels.py and
tests/test_torch_partition.py."""
import numpy as np
import pytest
import torch

from tpuray.scene.procedural import make_test_scene as jmake_test_scene

from tpuray_torch.integrator import intersect
from tpuray_torch.integrator.path_tracer import pack_traversal
from tpuray_torch.kernels import trace as kt
from tpuray_torch.kernels import trace_chunked as ktc
from tpuray_torch.scene.procedural import make_large_scene
from tpuray_torch.scene.types import scene_from_numpy, scene_to_numpy

torch.set_num_threads(2)

F32 = np.float32


@pytest.fixture(scope="module")
def single():
    scene = scene_from_numpy(scene_to_numpy(jmake_test_scene(subdiv=2, env_width=32)))
    return scene, kt.pack_scene(scene.bvh, scene.triangles)


@pytest.fixture(scope="module")
def forest():
    scene = make_large_scene(n_spheres=6, subdiv=2, max_chunk_tris=512,
                             env_width=32, device="cpu")
    return scene, pack_traversal(scene)


@pytest.fixture(scope="module")
def many_chunks():
    """>= 64 chunks, as the 524k forest has."""
    scene = make_large_scene(n_spheres=6, subdiv=2, max_chunk_tris=24,
                             env_width=32, device="cpu")
    return scene, pack_traversal(scene)


def _decode(ref):
    enc = ~np.asarray(ref, np.int64)
    return enc >> kt.LEAF_BITS, enc & ((1 << kt.LEAF_BITS) - 1)


@pytest.mark.parametrize("which", ["single", "forest"])
def test_records_unpack_to_soa(request, which):
    _, tables = request.getfixturevalue(which)
    meta, aabb = tables.meta.numpy(), tables.aabb.numpy()
    nodes = tables.nodes.numpy()
    n = tables.n_nodes
    first, count, right, axis, left_low = meta
    inner = np.flatnonzero((count == 0) & (aabb[0] <= aabb[3]))
    assert inner.size > 0
    boxes = nodes[inner, :12].view(F32)
    for col, (row, side) in enumerate([(0, "L"), (3, "L"), (1, "L"), (4, "L"),
                                       (0, "R"), (3, "R"), (1, "R"), (4, "R"),
                                       (2, "L"), (5, "L"), (2, "R"), (5, "R")]):
        child = inner + 1 if side == "L" else right[inner]
        np.testing.assert_array_equal(boxes[:, col].view(np.int32),
                                      aabb[row, child].view(np.int32))
    for k, child in ((12, inner + 1), (13, right[inner])):
        ref = nodes[inner, k]
        leaf = count[child] > 0
        np.testing.assert_array_equal(ref[~leaf], child[~leaf])
        f, c = _decode(ref[leaf])
        np.testing.assert_array_equal(f, first[child[leaf]])
        np.testing.assert_array_equal(c, count[child[leaf]])
    np.testing.assert_array_equal(nodes[inner, 14], axis[inner])
    np.testing.assert_array_equal(nodes[inner, 15], left_low[inner])
    other = np.setdiff1d(np.arange(n), inner)
    assert (nodes[other] == 0).all()
    assert tables.tris.shape == (tables.n_tris, 12)
    np.testing.assert_array_equal(tables.tris.numpy(), tables.tverts.numpy().T)
    if which == "single":
        assert tables.root == 0 and nodes.shape[0] == n
        np.testing.assert_array_equal(tables.root_box.numpy(), aabb[:, 0])
    else:
        assert nodes.shape[0] == n + tables.n_chunks - 1 and tables.root == n


def _safe_inv(d):
    tiny = np.where(d < 0, F32(-1e-20), F32(1e-20))
    return (F32(1.0) / np.where(np.abs(d) < F32(1e-20), tiny, d)).astype(F32)


def _slab(lox, hix, loy, hiy, loz, hiz, o, inv, limit):
    f0, n0 = (hix - o[:, 0]) * inv[:, 0], (lox - o[:, 0]) * inv[:, 0]
    f1, n1 = (hiy - o[:, 1]) * inv[:, 1], (loy - o[:, 1]) * inv[:, 1]
    f2, n2 = (hiz - o[:, 2]) * inv[:, 2], (loz - o[:, 2]) * inv[:, 2]
    t1 = np.minimum(np.maximum(f0, n0), np.minimum(np.maximum(f1, n1), np.maximum(f2, n2)))
    t0 = np.maximum(np.minimum(f0, n0), np.maximum(np.minimum(f1, n1), np.minimum(f2, n2)))
    return (t1 >= np.maximum(t0, F32(0))) & (t0 < limit) & (t1 > F32(0))


def _tri_test(tr, o, d):
    nx, ny, nz, np0, t1x, t1y, t1z, t1w, t2x, t2y, t2z, t2w = tr.T
    ox, oy, oz = o.T
    dx, dy, dz = d.T
    ndotd = nx * dx + ny * dy + nz * dz
    ndoto = nx * ox + ny * oy + nz * oz
    invalid = np.abs(ndotd) < F32(1e-5)
    t = (np0 - ndoto) / np.where(invalid, F32(1), ndotd)
    px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
    u = t1x * px + t1y * py + t1z * pz + t1w
    v = t2x * px + t2y * py + t2z * pz + t2w
    return ~invalid & (t >= F32(5e-4)) & (u > 0) & (v > 0) & (u + v < 1), t


def records_dfs(tables, o, d, tm, any_hit=False):
    """walk_subtree over the records for every ray at once: each step pops
    one node per ray that is still walking."""
    nodes = tables.nodes.numpy()
    boxes = nodes[:, :12].view(F32)
    tris = tables.tris.numpy()
    n = d.shape[0]
    o = np.broadcast_to(o, (n, 3)).astype(F32)
    inv = _safe_inv(d)
    t = np.full(n, F32(1e30))
    idx = np.full(n, -1, np.int64)
    stack = np.zeros((n, kt.MAX_STACK), np.int64)
    sp = np.zeros(n, np.int64)

    def scan(rows, refs):
        first, count = _decode(refs)
        for j in range(kt.MAX_LEAF):
            m = j < count
            if any_hit:
                m &= idx[rows] < 0
            r, ti = rows[m], first[m] + j
            hit, th = _tri_test(tris[ti], o[r], d[r])
            upd = hit & (th < t[r]) & (th < tm[r])
            t[r[upd]], idx[r[upd]] = th[upd], ti[upd]

    b = tables.root_box.numpy()
    live = np.flatnonzero((tm > 0) & _slab(b[0], b[3], b[1], b[4], b[2], b[5], o, inv, tm))
    if tables.root < 0:
        scan(live, np.full(live.size, tables.root))
    else:
        stack[live, 0], sp[live] = tables.root, 1
    while True:
        act = sp > 0
        if any_hit:
            act &= idx < 0
        rows = np.flatnonzero(act)
        if rows.size == 0:
            return t, idx
        sp[rows] -= 1
        node = stack[rows, sp[rows]]
        bx, link = boxes[node], nodes[node, 12:]
        limit = np.minimum(t[rows], tm[rows])
        hl = _slab(*bx[:, [0, 1, 2, 3, 8, 9]].T, o[rows], inv[rows], limit)
        hr = _slab(*bx[:, [4, 5, 6, 7, 10, 11]].T, o[rows], inv[rows], limit)
        nl = (d[rows, link[:, 2]] > 0) == (link[:, 3] == 1)
        near = np.where(nl, link[:, 0], link[:, 1])
        far = np.where(nl, link[:, 1], link[:, 0])
        hn, hf = np.where(nl, hl, hr), np.where(nl, hr, hl)
        m = hn & (near < 0)
        scan(rows[m], near[m])
        m = hf & (far < 0)
        if any_hit:
            m &= idx[rows] < 0
        scan(rows[m], far[m])
        for m, ref in ((hf & (far >= 0), far), (hn & (near >= 0), near)):
            r = rows[m]
            stack[r, sp[r]] = ref[m]
            sp[r] += 1


def _rays(seed, n, center, spread, common_origin):
    rng = np.random.default_rng(seed)
    o = np.tile(np.asarray([center], F32), (n, 1))
    if not common_origin:
        o += ((rng.random((n, 3)) - 0.5) * spread).astype(F32)
        o[: n // 8] = 0.0  # inside the boxes: negative slab t0
    tgt = ((rng.random((n, 3)) - 0.5) * 1.5).astype(F32)
    d = tgt - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(F32)


def _assert_closest(t, i, t_ref, i_ref):
    np.testing.assert_array_equal(t.view(np.int32), t_ref.view(np.int32))
    diff = i != i_ref
    assert (t[diff] == t_ref[diff]).all(), "idx differs without an exact-t tie"
    assert diff.sum() <= max(1, i.size // 1000)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("common_origin", [False, True])
@pytest.mark.parametrize("which", ["single", "forest"])
def test_records_dfs_matches_plain(request, which, common_origin, any_hit):
    """The kernels' walk over the records (K1, K3; K6 from the top-level
    root) against trace_packets_plain / trace_chunked_plain, which walk
    the SoA rows by skip links, with dead lanes and a finite t_max."""
    _, tables = request.getfixturevalue(which)
    n = 1024
    center, spread = (([0.0, 0.3, 2.0], 1.5) if which == "single"
                      else ([0.4, 0.6, 3.5], 5.0))
    o, d = _rays(n + int(common_origin), n, center, spread, common_origin)
    dead = np.arange(n) % 5 == 0
    shadow = 4.5 if which == "forest" and common_origin else 2.5  # reaches the geometry
    tm = np.where(dead, 0.0, shadow if any_hit else 1e30).astype(F32)
    plain = kt.trace_packets_plain if which == "single" else ktc.trace_chunked_plain
    t_ref, i_ref = plain(tables, torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(tm), any_hit, common_origin)
    t, i = records_dfs(tables, o[:1] if common_origin else o, d, tm, any_hit)
    i_ref = i_ref.numpy()
    if any_hit:
        np.testing.assert_array_equal(i >= 0, i_ref >= 0)
    else:
        _assert_closest(t, i, t_ref.numpy(), i_ref)
    assert (i[dead] == -1).all()
    assert 0.1 < (i_ref >= 0).mean() < 0.95


def test_records_dfs_many_chunks_matches_bruteforce(many_chunks):
    """A forest of >= 64 chunks (a top-level tree 6+ levels deep): the
    closest t of the walk from the top-level root equals the
    O(rays x triangles) oracle's."""
    scene, tables = many_chunks
    assert tables.n_chunks >= 64
    o, d = _rays(21, 256, [0.4, 0.6, 3.5], 5.0, False)
    t, i = records_dfs(tables, o, d, np.full(256, F32(1e30)))
    t_b, i_b = intersect.trace_bruteforce(scene.triangles, torch.from_numpy(o),
                                          torch.from_numpy(d))
    np.testing.assert_array_equal(t, t_b.numpy())
    np.testing.assert_array_equal(i >= 0, i_b.numpy() >= 0)
    assert 0.1 < (i >= 0).mean() < 0.95


@pytest.mark.parametrize("which", ["forest", "many_chunks"])
def test_top_level_reaches_every_chunk_root_once(request, which):
    _, tables = request.getfixturevalue(which)
    n, cn, c = tables.n_nodes, tables.chunk_nodes, tables.n_chunks
    nodes = tables.nodes.numpy()
    boxes = nodes[:, :12].view(F32)
    aabb = tables.aabb.numpy()
    reached, stack, depth = [], [(tables.root, 0)], 0
    while stack:
        ref, level = stack.pop()
        if ref >= n:  # a top-level record: check it bounds both children
            for k, cols in ((12, [0, 2, 8, 1, 3, 9]), (13, [4, 6, 10, 5, 7, 11])):
                child = nodes[ref, k]
                lo, hi = boxes[ref, cols[:3]], boxes[ref, cols[3:]]
                below = _chunk_roots_below(nodes, child, n)
                assert (aabb[:3, below].min(1) == lo).all()
                assert (aabb[3:, below].max(1) == hi).all()
                stack.append((int(child), level + 1))
        else:
            reached.append(ref)
            depth = max(depth, level)
    assert sorted(reached) == list(np.arange(c) * cn)  # every chunk root is inner here
    assert depth == int(np.ceil(np.log2(c)))
    root = np.arange(c) * cn
    np.testing.assert_array_equal(tables.root_box.numpy()[:3], aabb[:3, root].min(1))
    np.testing.assert_array_equal(tables.root_box.numpy()[3:], aabb[3:, root].max(1))


def _chunk_roots_below(nodes, ref, n):
    if ref < n:
        return [int(ref)]
    return (_chunk_roots_below(nodes, nodes[ref, 12], n)
            + _chunk_roots_below(nodes, nodes[ref, 13], n))


def test_top_level_tree_edge_cases():
    """One chunk: no top-level record, the root is the chunk root (a leaf
    ref when the chunk is a single leaf). Ties in the box centres split in
    a stable order; the refs of leaf chunks pass through untouched."""
    lo = np.asarray([[0, 0, 0]], F32)
    hi = np.asarray([[1, 2, 3]], F32)
    top = ktc.top_level_tree(lo, hi, np.asarray([kt.leaf_ref(5, 3)]), 100)
    assert top.records.shape == (0, 16) and top.root == kt.leaf_ref(5, 3)
    assert top.depth == 0 and top.root_box.tolist() == [0, 0, 0, 1, 2, 3]
    lo = np.zeros((5, 3), F32)
    hi = np.ones((5, 3), F32)
    refs = np.asarray([0, 10, kt.leaf_ref(7, 2), 30, 40])
    top = ktc.top_level_tree(lo, hi, refs, 50)
    assert top.records.shape == (4, 16) and top.root == 50 and top.depth == 3
    leaves = sorted(int(r) for r in top.records[:, 12:14].ravel() if r < 50)
    assert leaves == sorted(int(r) for r in refs)


def test_combined_depth_check_raises():
    """A chunk 120 levels deep fits the stack alone and overflows it under
    an 8-level top-level tree (256 chunks)."""
    depth = 120
    n = 2 * depth + 1
    cn = 384
    skip = np.full(cn, cn, np.int32)
    count = np.zeros(cn, np.int32)
    for k in range(depth):  # inner node 2k: left child 2k+1 (leaf), right 2k+2
        skip[2 * k + 1] = 2 * k + 2
    skip[0:n:2] = n
    skip[0] = cn
    count[1:n:2] = 1
    count[n - 1] = 1
    ktc._check_forest(skip, count, cn, top_depth=0)
    ktc._check_forest(skip, count, cn, top_depth=6)
    with pytest.raises(ValueError, match="top-level depth 8"):
        ktc._check_forest(skip, count, cn, top_depth=8)
