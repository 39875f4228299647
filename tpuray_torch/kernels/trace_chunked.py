"""K6: traversal of a uniform forest of chunk BVHs (large scenes).

Counterpart of tpuray/kernels/trace_chunked.py. The CUDA kernel is
csrc/trace_chunked.cu (see its header for the design); the wrapper

- runs the plain PyTorch version (integrator/intersect.py's skip-link
  wavefront over the forest arrays, what tpuray.integrator.intersect.trace
  computes on a forest) when its tensors lie on the CPU;
- on a CUDA tensor, checks device, dtype, shape and contiguity, allocates
  the outputs, launches the kernel on the current stream, raises if the
  launch failed, and adds one to LAUNCHES. There is no fallback, and no
  size gate: every forest goes to K6 on the card.

The forest layout is scene/partition.py:build_forest_bvh_uniform's: chunk
c owns node rows [c*CN, (c+1)*CN) and triangle rows [c*CT, (c+1)*CT), with
global indices. pack_forest keeps them global (kernels/trace.py:
pack_tables), so a hit's idx is the forest-wide triangle row, and appends
the inner records of a top-level tree over the chunk roots' boxes
(top_level_tree) after the forest's rows: the kernel walks the forest as
one tree from the top-level root. The forest's own rows, indices and
padding stay as partition.py lays them out.

Like K1-K3, both entries run under torch.no_grad: topology only, as the
JAX package's zero-tangent custom_jvp (tpuray/kernels/trace_chunked.py:
459-478).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpuray_torch.kernels import build
from tpuray_torch.kernels import trace as kt

Tensor = torch.Tensor

MAX_CHUNKS = 256  # leaves of the top-level tree over the chunk roots

# kernel launches since the last reset (the plain path never counts)
LAUNCHES = {"k6": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_forest(skip: np.ndarray, count: np.ndarray, chunk_nodes: int,
                  top_depth: int = 0) -> None:
    """Host-side bounds the kernel relies on, chunk by chunk (raises, so
    `python -O` keeps them): leaf size, a tree reached from the chunk root
    that stays inside its chunk's rows, and a DFS stack that fits
    MAX_STACK in any child order (tpuray/kernels/trace_chunked.py:267-283
    checks the JAX package's left-first order; the depth bound covers the
    kernel's near-first order) below a top-level tree top_depth deep."""
    if count.max() > kt.MAX_LEAF:
        raise ValueError(f"leaf count {count.max()} > MAX_LEAF={kt.MAX_LEAF}")
    n_nodes = skip.shape[0]
    lidx = np.minimum(np.arange(n_nodes) + 1, n_nodes - 1)
    right = np.where(count == 0, skip[lidx], 0)
    for c in range(n_nodes // chunk_nodes):
        lo, hi = c * chunk_nodes, (c + 1) * chunk_nodes
        stack, max_sp = [(lo, 0)], 1
        max_depth = 0
        while stack:
            nd, depth = stack.pop()
            if not lo <= nd < hi:
                raise ValueError(f"chunk {c}: node {nd} lies outside rows "
                                 f"[{lo}, {hi})")
            max_depth = max(max_depth, depth)
            if count[nd] == 0:
                if not nd + 1 < right[nd] < skip[nd]:
                    raise ValueError(f"chunk {c}: inner node {nd} has no "
                                     "right child inside its subtree")
                stack += [(int(right[nd]), depth + 1), (nd + 1, depth + 1)]
                max_sp = max(max_sp, len(stack))
        if max_sp >= kt.MAX_STACK or max_depth + 2 > kt.MAX_STACK:
            raise ValueError(f"chunk {c}: BVH needs stack {max_sp} (depth "
                             f"{max_depth}) >= {kt.MAX_STACK}")
        if top_depth + max_depth + 2 > kt.MAX_STACK:
            raise ValueError(
                f"chunk {c}: top-level depth {top_depth} + chunk depth "
                f"{max_depth} + 2 overflows the kernel's stack {kt.MAX_STACK}")


class TopLevel(NamedTuple):
    records: np.ndarray   # (n_chunks - 1, 16) int32, rows base, base + 1, ...
    root: int             # the top-level root's ref
    root_box: np.ndarray  # (6,) f32: min xyz, max xyz of every chunk root
    depth: int            # of the deepest chunk root below the root


def top_level_tree(lo: np.ndarray, hi: np.ndarray, refs: np.ndarray,
                   base: int) -> TopLevel:
    """A BVH2 over the chunk roots' boxes lo, hi (C, 3) f32, whose leaves
    are the chunk roots' refs (C,): median split on the widest axis of the
    box centres (as partition.partition_triangles splits triangles), inner
    records in preorder from row `base` in node_records' layout, with the
    child order of pack_tables (trace.split_axis). Boxes are exact unions,
    so a top-level box contains every box below it under the slab test's
    rounding too."""
    records: list = []

    def build(items: np.ndarray, depth: int):
        if len(items) == 1:
            c = int(items[0])
            return int(refs[c]), lo[c], hi[c], depth
        cen = 0.5 * (lo[items] + hi[items])
        axis = int(np.argmax(cen.max(0) - cen.min(0)))
        order = items[np.argsort(cen[:, axis], kind="stable")]
        row = len(records)
        records.append(None)
        half = len(order) // 2
        (lr, llo, lhi, ld), (rr, rlo, rhi, rd) = (build(order[:half], depth + 1),
                                                  build(order[half:], depth + 1))
        ax, left_low = kt.split_axis(torch.from_numpy(0.5 * (llo + lhi)),
                                     torch.from_numpy(0.5 * (rlo + rhi)))
        boxes = np.asarray([llo[0], lhi[0], llo[1], lhi[1], rlo[0], rhi[0],
                            rlo[1], rhi[1], llo[2], lhi[2], rlo[2], rhi[2]],
                           np.float32)
        records[row] = np.concatenate([
            boxes.view(np.int32),
            np.asarray([lr, rr, int(ax), int(left_low)], np.int32)])
        return (base + row, np.minimum(llo, rlo), np.maximum(lhi, rhi),
                max(ld, rd))

    root, rlo, rhi, depth = build(np.arange(len(refs)), 0)
    rec = (np.stack(records) if records
           else np.zeros((0, 16), np.int32))
    return TopLevel(rec, root, np.concatenate([rlo, rhi]).astype(np.float32),
                    depth)


def pack_forest(bvh, tri) -> kt.TraceTables:
    """Check a uniform forest (BVHSoA with chunk_nodes / chunk_tris) and
    pack it into the kernels' operand layout, on its device: the forest's
    rows (kernels/trace.py:pack_tables) and its top-level tree's records
    after them, rooted at the top-level root."""
    cn, ct = int(bvh.chunk_nodes), int(bvh.chunk_tris)
    n_nodes, n_tris = bvh.count, tri.count
    if cn <= 0 or ct <= 0:
        raise ValueError("pack_forest takes a chunked forest "
                         "(bvh.chunk_nodes > 0); pack a single tree with "
                         "kernels/trace.py:pack_scene")
    n_chunks = n_nodes // cn
    if n_nodes % cn or n_tris != n_chunks * ct:
        raise ValueError(f"{n_nodes} nodes / {n_tris} triangles are not "
                         f"whole chunks of {cn} / {ct}")
    if n_chunks > MAX_CHUNKS:
        raise ValueError(f"{n_chunks} chunks > MAX_CHUNKS={MAX_CHUNKS}")
    roots = np.arange(n_chunks) * cn
    count = bvh.tri_count.cpu().numpy()
    first = bvh.first_tri.cpu().numpy()
    refs = np.where(count[roots] > 0,
                    kt.leaf_ref(first[roots].astype(np.int64),
                                count[roots].astype(np.int64)), roots)
    top = top_level_tree(bvh.aabb_min[roots].cpu().numpy(),
                         bvh.aabb_max[roots].cpu().numpy(), refs, n_nodes)
    _check_forest(bvh.skip.cpu().numpy(), count, cn, top.depth)
    tables = kt.pack_tables(bvh, tri)
    dev = tables.nodes.device
    return dataclasses.replace(
        tables, chunk_nodes=cn, chunk_tris=ct,
        nodes=torch.cat([tables.nodes, torch.from_numpy(top.records).to(dev)]),
        root_box=torch.from_numpy(top.root_box).to(dev), root=top.root)


@torch.no_grad()
def trace_chunked_plain(tables: kt.TraceTables, orig: Tensor, d: Tensor,
                        t_max: Tensor | float, any_hit: bool = False,
                        common_origin: bool = False, stats: dict | None = None
                        ) -> tuple[Tensor, Tensor]:
    """K6's function in plain PyTorch: the skip-link wavefront over the
    forest, chunk by chunk in row order (padding nodes included: it steps
    through them one at a time). stats: the box tests on real nodes and
    the triangle tests (intersect.trace_arrays)."""
    return kt.trace_packets_plain(tables, orig, d, t_max, any_hit,
                                  common_origin, stats)


@torch.no_grad()
def trace_chunked(tables: kt.TraceTables, orig: Tensor, d: Tensor,
                  t_max: Tensor | float, any_hit: bool = False,
                  common_origin: bool = False) -> tuple[Tensor, Tensor]:
    """K6: closest-hit (or any-hit) trace of N rays through a forest.

    tables: pack_forest's. orig (N, 3), or (1, 3) with common_origin;
    d (N, 3) f32; t_max (N,) f32 or a scalar, <= 0 marks a dead lane.
    Returns (t (N,) f32, idx (N,) int32 forest-wide), (INF, -1) on a miss."""
    if d.device.type == "cpu":
        return trace_chunked_plain(tables, orig, d, t_max, any_hit,
                                   common_origin)
    if d.device.type != "cuda":
        raise ValueError(f"trace_chunked: unsupported device {d.device}")
    dev = d.device
    n = d.shape[0]
    t_max = kt._rays_tmax(t_max, n, dev)
    if common_origin:
        orig = orig[:1]
    kt._check_tables(tables, dev, forest=True)
    build.check(orig, "orig", torch.float32, (1 if common_origin else n, 3), dev)
    build.check(d, "d", torch.float32, (n, 3), dev)
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    idx_out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return t_out, idx_out
    with torch.cuda.device(dev):
        rc = build.load().tpuray_trace_chunked(
            *kt.record_args(tables), orig.data_ptr(),
            d.data_ptr(), t_max.data_ptr(), t_out.data_ptr(),
            idx_out.data_ptr(), n, int(any_hit), int(common_origin),
            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(rc, "trace_chunked (K6)")
    LAUNCHES["k6"] += 1
    return t_out, idx_out
