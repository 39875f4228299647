"""BVH traversal kernels K1 (trace_packets), K2 (trace_multi) and K3
(trace_batched) on a single tree.

Counterpart of tpuray/kernels/trace_pallas.py. The CUDA kernels live in
csrc/trace.cu (see its header for the design); each wrapper here

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

# kernel launches since the last reset (the plain path never counts)
LAUNCHES = {"k1": 0, "k2": 0, "k3": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class TraceTables:
    """The kernels' scene operands (pack_scene, or trace_chunked.pack_forest
    for a forest), plus the skip links that only the plain wavefront reads.
    Indices are global: first_tri and right point into the whole tables."""

    meta: Tensor    # (5, n_nodes) int32 [first_tri; tri_count; right; axis; left_low]
    aabb: Tensor    # (6, n_nodes) f32 [amin xyz; amax xyz]
    tverts: Tensor  # (12, T) f32 [n xyz; n.p0; T1 xyz; t1w; T2 xyz; t2w]
    skip: Tensor    # (n_nodes,) int32
    chunk_nodes: int = 0  # > 0: a uniform forest of chunks this many nodes long
    chunk_tris: int = 0

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


def pack_tables(bvh, tri) -> TraceTables:
    """The SoA scene in the kernels' operand layout, on its device, with no
    checks (pack_scene and trace_chunked.pack_forest check their trees).

    right_child of inner node i = skip[i + 1]; split_axis / left_is_low
    drive near-first child order."""
    skip, count = bvh.skip.long(), bvh.tri_count.long()
    n_nodes = skip.shape[0]
    left = torch.arange(n_nodes, device=skip.device) + 1
    clip_l = torch.clamp_max(left, n_nodes - 1)
    right = torch.where(count == 0, skip[clip_l], 0)
    center = 0.5 * (bvh.aabb_min + bvh.aabb_max)
    lc = center[clip_l]
    rc = center[torch.clamp_max(right, n_nodes - 1)]
    axis = torch.argmax(torch.abs(rc - lc), dim=-1)
    left_low = (torch.gather(lc, 1, axis[:, None])
                <= torch.gather(rc, 1, axis[:, None]))[:, 0]
    meta = torch.stack([bvh.first_tri.long(), count, right, axis,
                        left_low.long()]).to(torch.int32).contiguous()
    aabb = torch.cat([bvh.aabb_min.T, bvh.aabb_max.T]).contiguous()
    tc = intersect.triangle_constants(tri)
    tverts = torch.cat([tc["n"].T, tc["np0"][None], tc["t1"].T,
                        tc["t1w"][None], tc["t2"].T,
                        tc["t2w"][None]]).contiguous()
    return TraceTables(meta=meta, aabb=aabb, tverts=tverts,
                       skip=bvh.skip.to(torch.int32).contiguous())


def pack_scene(bvh, tri) -> TraceTables:
    """Check a single tree (_check_tree) and pack it (pack_tables)."""
    if bvh.chunk_nodes:
        raise ValueError("pack_scene takes a single tree; pack a chunked "
                         "forest with kernels/trace_chunked.py:pack_forest")
    _check_tree(bvh.skip.cpu().numpy(), bvh.tri_count.cpu().numpy())
    return pack_tables(bvh, tri)


def _constants(tables: TraceTables) -> dict[str, Tensor]:
    tv = tables.tverts
    return dict(n=tv[0:3].T, np0=tv[3], t1=tv[4:7].T, t1w=tv[7],
                t2=tv[8:11].T, t2w=tv[11])


def _rays_tmax(t_max, n: int, device) -> Tensor:
    return torch.as_tensor(t_max, dtype=torch.float32,
                           device=device).expand(n).contiguous()


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


def _ptr(x: Tensor | None):
    return None if x is None else x.data_ptr()


def _launch_single(entry: str, key: str, tables: TraceTables, orig: Tensor,
                   d: Tensor, t_max: Tensor | float, any_hit: bool
                   ) -> tuple[Tensor, Tensor]:
    """Check, allocate and launch K1 (orig (1, 3)) or K3 (orig (N, 3))."""
    dev = d.device
    n = d.shape[0]
    t_max = _rays_tmax(t_max, n, dev)
    _check_tables(tables, dev)
    build.check(orig, "orig", torch.float32, (1 if key == "k1" else n, 3), dev)
    build.check(d, "d", torch.float32, (n, 3), dev)
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    idx_out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return t_out, idx_out
    with torch.cuda.device(dev):
        rc = getattr(build.load(), entry)(
            tables.meta.data_ptr(), tables.aabb.data_ptr(),
            tables.tverts.data_ptr(), tables.n_nodes, tables.n_tris,
            orig.data_ptr(), d.data_ptr(), t_max.data_ptr(), t_out.data_ptr(),
            idx_out.data_ptr(), n, int(any_hit),
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
    f32; t_max (N,) f32 or a scalar, <= 0 marks a dead lane. Returns
    (t (N,) f32, idx (N,) int32), (INF, -1) on a miss. On the card K1 takes
    shared origins only (rays with their own origins go to K3,
    trace_batched); the plain version on the CPU takes either."""
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
    (shadow and bounce rays). Same outputs and dead-lane rule as K1."""
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
    """K2: M <= 3 ray classes from shared per-ray origins in one walk.

    orig (N, 3); dirs[c] (N, 3); t_maxs[c] (N,) (<= 0: dead in class c);
    any_hits[c] selects any-hit for class c. Returns [(t, idx)] per class,
    each equal to its own single-class trace (any-hit: up to which
    triangle is reported)."""
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
            tables.meta.data_ptr(), tables.aabb.data_ptr(),
            tables.tverts.data_ptr(), tables.n_nodes, tables.n_tris,
            orig.data_ptr(),
            *[_ptr(x) for x in list(dirs) + pad],
            *[_ptr(x) for x in t_maxs + pad],
            *[_ptr(x) for x in [t for t, _ in outs] + pad],
            *[_ptr(x) for x in [i for _, i in outs] + pad],
            n, m, mask, torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(rc, "trace_multi (K2)")
    LAUNCHES["k2"] += 1
    return outs
