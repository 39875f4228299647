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
pack_tables), so a hit's idx is the forest-wide triangle row.

Like K1-K3, both entries run under torch.no_grad: topology only, as the
JAX package's zero-tangent custom_jvp (tpuray/kernels/trace_chunked.py:
459-478).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuray_torch.kernels import build
from tpuray_torch.kernels import trace as kt

Tensor = torch.Tensor

MAX_CHUNKS = 256  # the kernel's per-thread list of entered chunks

# kernel launches since the last reset (the plain path never counts)
LAUNCHES = {"k6": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_forest(skip: np.ndarray, count: np.ndarray, chunk_nodes: int
                  ) -> None:
    """Host-side bounds the kernel relies on, chunk by chunk (raises, so
    `python -O` keeps them): leaf size, a tree reached from the chunk root
    that stays inside its chunk's rows, and a DFS stack that fits
    MAX_STACK in any child order (tpuray/kernels/trace_chunked.py:267-283
    checks the JAX package's left-first order; the depth bound covers the
    kernel's near-first order)."""
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


def pack_forest(bvh, tri) -> kt.TraceTables:
    """Check a uniform forest (BVHSoA with chunk_nodes / chunk_tris) and
    pack it into the kernels' operand layout, on its device."""
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
    _check_forest(bvh.skip.cpu().numpy(), bvh.tri_count.cpu().numpy(), cn)
    return dataclasses.replace(kt.pack_tables(bvh, tri), chunk_nodes=cn,
                               chunk_tris=ct)


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
            tables.meta.data_ptr(), tables.aabb.data_ptr(),
            tables.tverts.data_ptr(), tables.n_nodes, tables.n_tris,
            tables.chunk_nodes, tables.n_chunks, orig.data_ptr(),
            d.data_ptr(), t_max.data_ptr(), t_out.data_ptr(),
            idx_out.data_ptr(), n, int(any_hit), int(common_origin),
            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(rc, "trace_chunked (K6)")
    LAUNCHES["k6"] += 1
    return t_out, idx_out
