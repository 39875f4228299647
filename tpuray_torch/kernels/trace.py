"""BVH traversal kernels K1 (trace_packets), K2 (trace_multi) and K3
(trace_batched) on a single tree.

Counterpart of tpuray/kernels/trace_pallas.py. The CUDA kernels live in
csrc/trace.cu (K2, over the binary records) and csrc/trace_wide.cu (K1,
one walk a warp, and K3, one walk a thread, both over the same tree
collapsed into 4-wide records, wide_tree); see their headers for the
designs. Each wrapper here

- runs the plain PyTorch version (integrator/intersect.py's skip-link
  wavefront) when its tensors lie on the CPU;
- on a CUDA tensor, checks device, dtype, shape and contiguity, allocates
  the outputs, launches the kernel on the current stream, raises if the
  launch failed, and adds one to LAUNCHES. There is no fallback.

K1 takes rays with a shared origin (camera primaries), K3 rays with their
own origins (the separate-walk secondaries, the MIS integrator). Chunked
forests go to K6 (kernels/trace_chunked.py), which packs its tables with
pack_tables below.

Traversal returns topology only, (t, triangle index) with (INF, -1) on a
miss; shading re-derives everything else (integrator/path_tracer.py).
Every entry here, kernel or plain, runs under torch.no_grad, so its
outputs never require grad whatever its inputs do: the topology-only
contract of the JAX package's zero-tangent custom_jvp
(tpuray/kernels/trace_pallas.py:810-858). Gradients flow through the
shading that resolve_hit re-derives from the detached t.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from tpuray_torch.integrator import intersect
from tpuray_torch.kernels import build

Tensor = torch.Tensor

MAX_STACK = 128  # per-thread DFS stack in the kernels; checked at pack time
MAX_LEAF = 8     # builder leaf size; checked at pack time
LEAF_BITS = 4    # a leaf ref packs its count (<= MAX_LEAF) in this many bits
WIDE = 4         # children of a wide node (K3)
WIDE_STACK = 64  # K3's per-thread stack (csrc/trace_wide.cu); checked at pack time
WIDE_EMPTY = -1  # the ref of an unused wide slot (a leaf ref is -1 only with no triangle)

# kernel launches since the last reset (the plain path never counts)
LAUNCHES = {"k1": 0, "k2": 0, "k3": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class TraceTables:
    """The kernels' scene operands (pack_scene, or trace_chunked.pack_forest
    for a forest). The plain versions read the SoA rows (meta, aabb, tverts
    and the skip links); the kernels read the packed records (nodes, tris,
    root_box, root; csrc/trace_common.cuh), K3 the wide records in place of
    nodes (wide, wide_root; csrc/trace_wide.cu). Indices are global:
    first_tri, right and every ref point into the whole tables."""

    meta: Tensor    # (5, n_nodes) int32 [first_tri; tri_count; right; axis; left_low]
    aabb: Tensor    # (6, n_nodes) f32 [amin xyz; amax xyz]
    tverts: Tensor  # (12, T) f32 [n xyz; n.p0; T1 xyz; t1w; T2 xyz; t2w]
    skip: Tensor    # (n_nodes,) int32
    nodes: Tensor   # (R >= n_nodes, 16) int32 bits: one 64-byte record per inner node row
    tris: Tensor    # (T, 12) f32: tverts.T, one 48-byte record per triangle
    root_box: Tensor  # (6,) f32: the walk's root box, min xyz, max xyz
    root: int       # the walk's root ref (leaf_ref(...) when the root is a leaf)
    chunk_nodes: int = 0  # > 0: a uniform forest of chunks this many nodes long
    chunk_tris: int = 0
    wide: Tensor | None = None  # (R4, 32) int32 bits: K3's 4-wide records (pack_scene)
    wide_root: int = 0          # K3's root ref: a wide row, or the root leaf's ref

    @property
    def n_nodes(self) -> int:
        return self.meta.shape[1]

    @property
    def n_tris(self) -> int:
        return self.tverts.shape[1]

    @property
    def n_chunks(self) -> int:
        return self.n_nodes // self.chunk_nodes if self.chunk_nodes else 0


def _check_tree(skip: np.ndarray, count: np.ndarray) -> None:
    """Host-side bounds the kernels rely on (checked with raises, not
    asserts, so `python -O` keeps them): leaf size, a strict binary preorder
    tree, and a DFS stack that fits MAX_STACK in any child order."""
    n_nodes = skip.shape[0]
    if count.max() > MAX_LEAF:
        raise ValueError(f"leaf count {count.max()} > MAX_LEAF={MAX_LEAF}")
    empty_leaf = (count == 0) & (skip == np.arange(n_nodes) + 1)
    if empty_leaf.any():
        raise ValueError(
            "tree contains empty-leaf nodes (count=0, skip=i+1): a forest or "
            "padded layout; the single-tree kernels need a strict binary tree")
    lidx = np.minimum(np.arange(n_nodes) + 1, n_nodes - 1)
    right = np.where(count == 0, skip[lidx], 0)
    # the JAX package's bound: left-first DFS that pushes both children
    stack, max_sp = [0], 1
    while stack:
        nd = stack.pop()
        if count[nd] == 0:
            stack += [int(right[nd]), nd + 1]
            max_sp = max(max_sp, len(stack))
    if max_sp >= MAX_STACK:
        raise ValueError(f"BVH needs stack {max_sp} >= {MAX_STACK}")
    # the kernels visit near-first by each ray's own direction: whatever the
    # order, the stack holds at most one pending sibling per level
    depth = np.zeros(n_nodes, np.int64)
    for i in np.flatnonzero(count == 0):
        depth[i + 1] = depth[i] + 1
        depth[right[i]] = depth[i] + 1
    if depth.max() + 2 > MAX_STACK:
        raise ValueError(
            f"BVH depth {depth.max()} overflows the kernels' stack {MAX_STACK}")


def split_axis(lc: Tensor, rc: Tensor) -> tuple[Tensor, Tensor]:
    """(axis, left_low) of inner nodes whose children's box centres are lc
    and rc (..., 3): the axis of their largest separation, and whether the
    left child lies low on it (the kernels' near-first child order)."""
    axis = torch.argmax(torch.abs(rc - lc), dim=-1)
    pick = lambda c: torch.gather(c, -1, axis[..., None])[..., 0]
    return axis, pick(lc) <= pick(rc)


def leaf_ref(first, count):
    """A child ref naming a leaf: ~(first_tri << LEAF_BITS | tri_count)."""
    return ~((first << LEAF_BITS) | count)


def node_records(meta: Tensor, aabb: Tensor) -> Tensor:
    """(n_nodes, 16) int32: the record of each inner node row
    (csrc/trace_common.cuh): its children's boxes as f32 bits
    [L.min.x, L.max.x, L.min.y, L.max.y, R.min.x, R.max.x, R.min.y,
    R.max.y, L.min.z, L.max.z, R.min.z, R.max.z], then its left and right
    child refs (an inner child's row, or leaf_ref), axis and left_low.
    Leaf and padding rows are zero and never read."""
    first, count, right, axis, left_low = meta.long()
    n = count.shape[0]
    left = torch.clamp_max(torch.arange(n, device=meta.device) + 1, n - 1)
    right = torch.clamp(right, 0, n - 1)
    lo, hi = aabb[0:3], aabb[3:6]
    boxes = torch.stack([lo[0][left], hi[0][left], lo[1][left], hi[1][left],
                         lo[0][right], hi[0][right], lo[1][right], hi[1][right],
                         lo[2][left], hi[2][left], lo[2][right], hi[2][right]], 1)

    def ref(c):
        return torch.where(count[c] > 0, leaf_ref(first[c], count[c]), c)

    links = torch.stack([ref(left), ref(right), axis, left_low], 1)
    rec = torch.cat([boxes.view(torch.int32), links.to(torch.int32)], 1)
    inner = (count == 0) & (aabb[0] <= aabb[3])  # padding boxes are inverted
    return torch.where(inner[:, None], rec, 0).contiguous()


@dataclasses.dataclass(frozen=True)
class WideTree:
    """The binary tree collapsed into 4-wide nodes (wide_tree)."""

    records: np.ndarray  # (R4, 32) int32: one 128-byte record per wide node
    root: int            # row 0, or the root leaf's ref when the root is a leaf
    stack: int           # the most entries K3's stack can hold, in any child order


def wide_tree(meta: np.ndarray, aabb: np.ndarray) -> WideTree:
    """K3's records (csrc/trace_wide.cu) from a binary tree's SoA rows
    meta (5, n) and aabb (6, n): each wide node starts from a binary inner
    node's two children and replaces the inner child of largest surface
    area by its two children until it has WIDE children or only leaves.
    Each record holds its children's boxes as f32 bits, min x, max x,
    min y, max y, min z, max z, four of each (the binary nodes' own boxes,
    +inf in unused slots), then the four child refs (a wide row, a
    leaf_ref, or WIDE_EMPTY) and four zeros. Wide rows are numbered level
    by level. Raises if a walk could need more than WIDE_STACK entries."""
    first, count, right = (meta[k].astype(np.int64) for k in range(3))
    lo, hi = aabb[:3].T, aabb[3:].T
    ext = (hi - lo).astype(np.float64)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    if count[0] > 0:
        return WideTree(np.zeros((0, 8 * WIDE), np.int32),
                        int(leaf_ref(first[0], count[0])), 0)
    levels, frontier = [], np.zeros(1, np.int64)
    while frontier.size:
        rows = np.arange(frontier.size)
        kids = np.full((frontier.size, WIDE), -1, np.int64)
        kids[:, 0], kids[:, 1] = frontier + 1, right[frontier]
        for slot in range(2, WIDE):
            a = np.where(count[kids[:, :slot]] == 0, area[kids[:, :slot]], -1.0)
            best = np.argmax(a, axis=1)
            grow = a[rows, best] >= 0.0
            b = kids[rows[grow], best[grow]]
            kids[rows[grow], best[grow]] = b + 1
            kids[rows[grow], slot] = right[b]
        inner = (kids >= 0) & (count[np.maximum(kids, 0)] == 0)
        levels.append((kids, inner))
        frontier = kids[inner]
    starts = np.cumsum([0] + [k.shape[0] for k, _ in levels])
    records, need = [], np.zeros(0, np.int64)
    for level in range(len(levels) - 1, -1, -1):  # bottom-up: stack need
        kids, inner = levels[level]
        safe = np.maximum(kids, 0)
        row = np.full(kids.shape, -1, np.int64)
        row[inner] = starts[level + 1] + np.arange(int(inner.sum()))
        refs = np.where(inner, row, np.where(kids >= 0, leaf_ref(first[safe], count[safe]),
                                             WIDE_EMPTY))
        box = np.where((kids >= 0)[..., None], np.concatenate([lo, hi], 1)[safe],
                       np.float32(np.inf)).astype(np.float32)  # (F, WIDE, 6)
        bounds = box[:, :, [0, 3, 1, 4, 2, 5]].transpose(0, 2, 1).reshape(-1, 6 * WIDE)
        records.append(np.concatenate([bounds.view(np.int32), refs.astype(np.int32),
                                       np.zeros((kids.shape[0], WIDE), np.int32)], 1))
        below = np.where(inner, need[np.maximum(row - starts[level + 1], 0)]
                         if need.size else 0, -1)
        n_in = inner.sum(1)
        need = np.where(n_in > 0, n_in - 1 + below.max(1), 0)
    if need[0] > WIDE_STACK:
        raise ValueError(f"the wide BVH needs a stack of {need[0]} > "
                         f"WIDE_STACK={WIDE_STACK}")
    return WideTree(np.concatenate(records[::-1]), 0, int(need[0]))


def pack_tables(bvh, tri) -> TraceTables:
    """The scene in the kernels' operand layout, on its device, with no
    tree checks (pack_scene and trace_chunked.pack_forest check their
    trees): the SoA rows and the records, rooted at node 0.

    right_child of inner node i = skip[i + 1]; split_axis / left_is_low
    drive near-first child order."""
    skip, count = bvh.skip.long(), bvh.tri_count.long()
    n_nodes = skip.shape[0]
    if tri.count >= 1 << (31 - LEAF_BITS):
        raise ValueError(f"{tri.count} triangles overflow a leaf ref")
    left = torch.arange(n_nodes, device=skip.device) + 1
    clip_l = torch.clamp_max(left, n_nodes - 1)
    right = torch.where(count == 0, skip[clip_l], 0)
    center = 0.5 * (bvh.aabb_min + bvh.aabb_max)
    axis, left_low = split_axis(center[clip_l],
                                center[torch.clamp_max(right, n_nodes - 1)])
    meta = torch.stack([bvh.first_tri.long(), count, right, axis,
                        left_low.long()]).to(torch.int32).contiguous()
    aabb = torch.cat([bvh.aabb_min.T, bvh.aabb_max.T]).contiguous()
    tc = intersect.triangle_constants(tri)
    tverts = torch.cat([tc["n"].T, tc["np0"][None], tc["t1"].T,
                        tc["t1w"][None], tc["t2"].T,
                        tc["t2w"][None]]).contiguous()
    c0, f0 = int(count[0]), int(bvh.first_tri[0])
    return TraceTables(meta=meta, aabb=aabb, tverts=tverts,
                       skip=bvh.skip.to(torch.int32).contiguous(),
                       nodes=node_records(meta, aabb),
                       tris=tverts.T.contiguous(),
                       root_box=aabb[:, 0].contiguous(),
                       root=leaf_ref(f0, c0) if c0 else 0)


def pack_scene(bvh, tri) -> TraceTables:
    """Check a single tree (_check_tree) and pack it (pack_tables), with
    K3's wide records (wide_tree)."""
    if bvh.chunk_nodes:
        raise ValueError("pack_scene takes a single tree; pack a chunked "
                         "forest with kernels/trace_chunked.py:pack_forest")
    _check_tree(bvh.skip.cpu().numpy(), bvh.tri_count.cpu().numpy())
    tables = pack_tables(bvh, tri)
    wide = wide_tree(tables.meta.cpu().numpy(), tables.aabb.detach().cpu().numpy())
    return dataclasses.replace(tables, wide=torch.from_numpy(wide.records).to(
        tables.meta.device), wide_root=wide.root)


def _constants(tables: TraceTables) -> dict[str, Tensor]:
    tv = tables.tverts
    return dict(n=tv[0:3].T, np0=tv[3], t1=tv[4:7].T, t1w=tv[7],
                t2=tv[8:11].T, t2w=tv[11])


def _rays_tmax(t_max, n: int, device) -> Tensor:
    """(n,) f32 t_max on `device`. A float is filled in on the device:
    torch.as_tensor would copy it from pageable host memory, and PyTorch
    waits for the stream after such a copy."""
    if isinstance(t_max, torch.Tensor):
        return torch.as_tensor(t_max, dtype=torch.float32,
                               device=device).expand(n).contiguous()
    return torch.full((n,), float(t_max), dtype=torch.float32, device=device)


# ------------------------------------------------------------ plain versions

@torch.no_grad()
def trace_packets_plain(tables: TraceTables, orig: Tensor, d: Tensor,
                        t_max: Tensor | float, any_hit: bool = False,
                        common_origin: bool = False, stats: dict | None = None
                        ) -> tuple[Tensor, Tensor]:
    """K1's and K3's function in plain PyTorch (and K6's, on forest
    tables): intersect.trace on the packed tables, for shared or per-ray
    origins. common_origin: orig may be (1, 3), shared by every ray. stats:
    counts the box and triangle tests (intersect.trace_arrays)."""
    n = d.shape[0]
    t_max = _rays_tmax(t_max, n, d.device)
    return intersect.trace_arrays(
        tables.aabb[0:3].T, tables.aabb[3:6].T, tables.meta[0],
        tables.meta[1], tables.skip, _constants(tables),
        orig.expand(n, 3), d, t_max, any_hit, stats)


@torch.no_grad()
def trace_multi_plain(tables: TraceTables, orig: Tensor,
                      dirs: Sequence[Tensor], t_maxs: Sequence[Tensor],
                      any_hits: Sequence[bool], stats: dict | None = None
                      ) -> list[tuple[Tensor, Tensor]]:
    """K2's function in plain PyTorch: one single-class trace per class."""
    return [trace_packets_plain(tables, orig, d, tm, ah, stats=stats)
            for d, tm, ah in zip(dirs, t_maxs, any_hits)]


# ------------------------------------------------------------ kernel wrappers

def _check_tables(tables: TraceTables, device: torch.device,
                  forest: bool = False) -> None:
    if bool(tables.chunk_nodes) != forest:
        raise ValueError("K6 takes forest tables (trace_chunked.pack_forest), "
                         "K1-K3 single-tree tables (pack_scene)")
    nn, nt = tables.n_nodes, tables.n_tris
    build.check(tables.meta, "meta", torch.int32, (5, nn), device)
    build.check(tables.aabb, "aabb", torch.float32, (6, nn), device)
    build.check(tables.tverts, "tverts", torch.float32, (12, nt), device)
    build.check(tables.nodes, "nodes", torch.int32,
                (max(nn, tables.nodes.shape[0]), 16), device)
    build.check(tables.tris, "tris", torch.float32, (nt, 12), device)
    build.check(tables.root_box, "root_box", torch.float32, (6,), device)


def record_args(tables: TraceTables) -> tuple:
    """The binary walks' scene arguments (K2 here, K6 in
    trace_chunked.py): nodes, tris, root_box, root."""
    return (tables.nodes.data_ptr(), tables.tris.data_ptr(),
            tables.root_box.data_ptr(), tables.root)


def _ptr(x: Tensor | None):
    return None if x is None else x.data_ptr()


def wide_args(tables: TraceTables) -> tuple:
    """K1's and K3's scene arguments: wide, tris, root_box, wide_root."""
    return (tables.wide.data_ptr(), tables.tris.data_ptr(),
            tables.root_box.data_ptr(), tables.wide_root)


def _launch_single(entry: str, key: str, tables: TraceTables, orig: Tensor,
                   d: Tensor, t_max: Tensor | float, any_hit: bool
                   ) -> tuple[Tensor, Tensor]:
    """Check, allocate and launch K1 (orig (1, 3); a float t_max goes to
    the kernel as an argument) or K3 (orig (N, 3)), both over the wide
    records."""
    dev = d.device
    n = d.shape[0]
    scalar = key == "k1" and not isinstance(t_max, torch.Tensor)
    t_max = float(t_max) if scalar else _rays_tmax(t_max, n, dev)
    _check_tables(tables, dev)
    if tables.wide is None:
        raise ValueError(f"{entry} ({key.upper()}) walks pack_scene's wide "
                         "records; these tables have none")
    build.check(tables.wide, "wide", torch.int32,
                (tables.wide.shape[0], 8 * WIDE), dev)
    build.check(orig, "orig", torch.float32, (1 if key == "k1" else n, 3), dev)
    build.check(d, "d", torch.float32, (n, 3), dev)
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    idx_out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return t_out, idx_out
    if key == "k1":  # K1's entry takes (t_max or NULL, t_max_all)
        t_args = (None, t_max) if scalar else (t_max.data_ptr(), 0.0)
    else:
        t_args = (t_max.data_ptr(),)
    with torch.cuda.device(dev):
        rc = getattr(build.load(), entry)(
            *wide_args(tables), orig.data_ptr(), d.data_ptr(), *t_args,
            t_out.data_ptr(), idx_out.data_ptr(), n, int(any_hit),
            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(rc, f"{entry} ({key.upper()})")
    LAUNCHES[key] += 1
    return t_out, idx_out


@torch.no_grad()
def trace_packets(tables: TraceTables, orig: Tensor, d: Tensor,
                  t_max: Tensor | float, any_hit: bool = False,
                  common_origin: bool = False) -> tuple[Tensor, Tensor]:
    """K1: closest-hit (or any-hit) trace of N rays from one shared origin.

    orig (1, 3) or (N, 3) rows of one point, with common_origin; d (N, 3)
    f32; t_max (N,) f32 or a float (passed to the kernel as an argument:
    nothing is copied to the card), <= 0 marks a dead lane. Returns
    (t (N,) f32, idx (N,) int32), (INF, -1) on a miss. On the card K1 walks
    pack_scene's wide records a warp at a time and takes shared origins
    only (rays with their own origins go to K3, trace_batched); the plain
    version on the CPU takes either."""
    if d.device.type == "cpu":
        return trace_packets_plain(tables, orig, d, t_max, any_hit,
                                   common_origin)
    if d.device.type != "cuda":
        raise ValueError(f"trace_packets: unsupported device {d.device}")
    if not common_origin:
        raise ValueError("trace_packets (K1) takes a shared origin "
                         "(common_origin=True); per-ray origins go to "
                         "trace_batched (K3)")
    return _launch_single("tpuray_trace_packets", "k1", tables, orig[:1], d,
                          t_max, any_hit)


@torch.no_grad()
def trace_batched(tables: TraceTables, orig: Tensor, d: Tensor,
                  t_max: Tensor | float, any_hit: bool = False
                  ) -> tuple[Tensor, Tensor]:
    """K3: K1's trace for incoherent rays with per-ray origins orig (N, 3)
    (shadow and bounce rays), over pack_scene's wide records on the card.
    Same outputs and dead-lane rule as K1; idx may differ from K1's or
    K2's walk of the same rays only at exact-t ties."""
    if d.device.type == "cpu":
        return trace_packets_plain(tables, orig, d, t_max, any_hit)
    if d.device.type != "cuda":
        raise ValueError(f"trace_batched: unsupported device {d.device}")
    return _launch_single("tpuray_trace_batched", "k3", tables, orig, d,
                          t_max, any_hit)


@torch.no_grad()
def trace_multi(tables: TraceTables, orig: Tensor, dirs: Sequence[Tensor],
                t_maxs: Sequence[Tensor], any_hits: Sequence[bool]
                ) -> list[tuple[Tensor, Tensor]]:
    """K2: M <= 3 ray classes from shared per-ray origins in one launch.

    orig (N, 3); dirs[c] (N, 3); t_maxs[c] (N,) (<= 0: dead in class c);
    any_hits[c] selects any-hit for class c. Returns [(t, idx)] per class,
    each equal to its own single-class trace: on the card, K1's walk in
    one thread per (ray, class), so each class equals trace_batched of that
    class alone up to exact-t ties (K3 walks the wide records)."""
    m = len(dirs)
    if not (1 <= m <= 3 and len(t_maxs) == m and len(any_hits) == m):
        raise ValueError(f"trace_multi takes 1..3 classes, got {m}")
    if orig.device.type == "cpu":
        return trace_multi_plain(tables, orig, dirs, t_maxs, any_hits)
    if orig.device.type != "cuda":
        raise ValueError(f"trace_multi: unsupported device {orig.device}")
    dev = orig.device
    n = orig.shape[0]
    _check_tables(tables, dev)
    build.check(orig, "orig", torch.float32, (n, 3), dev)
    t_maxs = [_rays_tmax(tm, n, dev) for tm in t_maxs]
    for c in range(m):
        build.check(dirs[c], f"dirs[{c}]", torch.float32, (n, 3), dev)
    outs = [(torch.empty(n, dtype=torch.float32, device=dev),
             torch.empty(n, dtype=torch.int32, device=dev)) for _ in range(m)]
    if n == 0:
        return outs
    pad = [None] * (3 - m)
    mask = sum(1 << c for c in range(m) if any_hits[c])
    with torch.cuda.device(dev):
        rc = build.load().tpuray_trace_multi(
            *record_args(tables), orig.data_ptr(),
            *[_ptr(x) for x in list(dirs) + pad],
            *[_ptr(x) for x in t_maxs + pad],
            *[_ptr(x) for x in [t for t, _ in outs] + pad],
            *[_ptr(x) for x in [i for _, i in outs] + pad],
            n, m, mask, torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(rc, "trace_multi (K2)")
    LAUNCHES["k2"] += 1
    return outs
