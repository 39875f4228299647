"""Ray intersection: triangle test, AABB slab test, skip-link BVH traversal.

Counterpart of tpuray/integrator/intersect.py in plain PyTorch. `trace`
is the single-pointer skip-link wavefront: every ray advances one node or
one triangle per step, so its decisions and tie-breaking are those of the
JAX function. It is the plain version the traversal kernels
(kernels/trace.py) are held against, and what they run on CPU tensors.

The float op order of `ray_triangle_pre` is the JAX package's; the CUDA
traversal kernels (csrc/trace_common.cuh) repeat it with FMA contraction
off, so a kernel's t equals this function's t bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

INF = float(np.float32(1e30))
T_MIN = float(np.float32(5e-4))
PARALLEL_EPS = float(np.float32(1e-5))
# a wavefront checks for "all rays done" (a host sync) every this many steps;
# finished lanes are frozen, so the extra steps change nothing
_SYNC_EVERY = 16


def cross(a: Tensor, b: Tensor) -> Tensor:
    """Cross product over the last axis, in jnp.cross's op order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def norm(v: Tensor, keepdim: bool = True) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def triangle_constants(tri) -> dict[str, Tensor]:
    """Per-triangle intersection constants (plane + two barycentric plane
    transforms): t = (np0 - n.o)/(n.d), u = T1.p + t1w, v = T2.p + t2w,
    hit iff u > 0, v > 0, u + v < 1. Degenerate triangles never hit."""
    p0, p1, p2 = tri.p0, tri.p1, tri.p2
    e1 = p1 - p0
    e2 = p2 - p0
    nraw = cross(e1, e2)
    nlen = norm(nraw)
    n = nraw / torch.clamp_min(nlen, 1e-30)
    degenerate = (nlen < 1e-20)[..., 0]

    a1 = cross(e2, n)
    det1 = torch.sum(e1 * a1, dim=-1, keepdim=True)
    t1 = a1 / torch.where(torch.abs(det1) < 1e-30, 1.0, det1)
    a2 = cross(e1, n)
    det2 = torch.sum(e2 * a2, dim=-1, keepdim=True)
    t2 = a2 / torch.where(torch.abs(det2) < 1e-30, 1.0, det2)
    zero = torch.where(degenerate[..., None], 0.0, 1.0)
    n = n * zero
    t1 = t1 * zero
    t2 = t2 * zero
    return dict(
        n=n, np0=torch.sum(n * p0, dim=-1),
        t1=t1, t1w=-torch.sum(t1 * p0, dim=-1) * zero[..., 0],
        t2=t2, t2w=-torch.sum(t2 * p0, dim=-1) * zero[..., 0],
    )


def ray_triangle_pre(ox, oy, oz, dx, dy, dz,
                     nx, ny, nz, np0, t1x, t1y, t1z, t1w,
                     t2x, t2y, t2z, t2w) -> tuple[Tensor, Tensor]:
    """Scalarized precomputed triangle test. Returns (hit, t)."""
    ndotd = nx * dx + ny * dy + nz * dz
    ndoto = nx * ox + ny * oy + nz * oz
    invalid = torch.abs(ndotd) < PARALLEL_EPS
    denom = torch.where(invalid, 1.0, ndotd)
    t = (np0 - ndoto) / denom
    px = ox + dx * t
    py = oy + dy * t
    pz = oz + dz * t
    u = t1x * px + t1y * py + t1z * pz + t1w
    v = t2x * px + t2y * py + t2z * pz + t2w
    in_tri = (u > 0) & (v > 0) & (u + v < 1)
    hit = torch.logical_not(invalid) & (t >= T_MIN) & in_tri
    return hit, torch.where(hit, t, INF)


def ray_aabb(orig: Tensor, inv_d: Tensor, amin: Tensor, amax: Tensor,
             t_limit: Tensor) -> Tensor:
    """Slab test: hit iff the box overlaps (0, t_limit] along the ray."""
    f = (amax - orig) * inv_d
    n = (amin - orig) * inv_d
    t1 = torch.amin(torch.maximum(f, n), dim=-1)
    t0 = torch.amax(torch.minimum(f, n), dim=-1)
    return (t1 >= torch.clamp_min(t0, 0.0)) & (t0 < t_limit) & (t1 > 0.0)


def safe_inv(d: Tensor) -> Tensor:
    """1/d with |d| < 1e-20 clamped to +-1e-20 (sign kept)."""
    tiny = torch.where(d < 0, -1e-20, 1e-20)
    return 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)


def trace_arrays(aabb_min: Tensor, aabb_max: Tensor, first_tri: Tensor,
                 tri_count: Tensor, skip: Tensor, tc: dict[str, Tensor],
                 orig: Tensor, d: Tensor, t_max: Tensor | float = INF,
                 any_hit: bool = False, stats: dict | None = None
                 ) -> tuple[Tensor, Tensor]:
    """The skip-link wavefront over raw node arrays and triangle constants
    (`trace` and the kernels' plain path both land here).

    stats: if given, adds the box tests and triangle tests these rays
    needed to stats["box_tests"] and stats["tri_tests"] (the work a
    roofline bound counts). Box tests of a forest's padding nodes (inverted
    boxes, scene/partition.py) are not counted: a walk from the chunk
    roots never reaches them."""
    n_nodes = aabb_min.shape[0]
    n_tris = tc["np0"].shape[0]
    n = orig.shape[0]
    dev = orig.device
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    # dead lanes (t_max <= 0) snap to -INF so an origin inside a box (negative
    # slab t0) cannot pass the `t0 < limit` test
    t_max = torch.where(t_max <= 0.0, -INF, t_max)
    inv_d = safe_inv(d)
    first_tri = first_tri.long()
    tri_count = tri_count.long()
    skip = skip.long()
    ox, oy, oz = orig[:, 0], orig[:, 1], orig[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    # one (T, 12) row per triangle: one gather per step instead of twelve
    rows = torch.cat([tc["n"], tc["np0"][:, None], tc["t1"],
                      tc["t1w"][:, None], tc["t2"], tc["t2w"][:, None]], 1)

    node = torch.zeros(n, dtype=torch.long, device=dev)
    j = torch.zeros(n, dtype=torch.long, device=dev)
    t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    idx = torch.full((n,), -1, dtype=torch.long, device=dev)
    real_node = (aabb_min[:, 0] <= aabb_max[:, 0]) if stats is not None else None
    n_box = torch.zeros((), dtype=torch.long, device=dev)
    n_tri = torch.zeros((), dtype=torch.long, device=dev)
    step = 0
    while True:
        active = node < n_nodes
        if step % _SYNC_EVERY == 0 and not bool(active.any()):
            break
        step += 1
        nd = torch.clamp_max(node, n_nodes - 1)
        count = tri_count[nd]
        first = first_tri[nd]
        is_leaf = count > 0
        entering = j == 0
        box_ok = torch.where(
            entering,
            ray_aabb(orig, inv_d, aabb_min[nd], aabb_max[nd],
                     torch.minimum(t, t_max)),
            True)

        do_tri = active & is_leaf & box_ok
        if stats is not None:
            n_box += (active & entering & real_node[nd]).sum()
            n_tri += do_tri.sum()
        ti = torch.clamp(first + j, 0, n_tris - 1)
        hit, t_tri = ray_triangle_pre(ox, oy, oz, dx, dy, dz,
                                      *rows[ti].unbind(1))
        upd = do_tri & hit & (t_tri < t) & (t_tri < t_max)
        t = torch.where(upd, t_tri, t)
        idx = torch.where(upd, ti, idx)

        j_next = j + 1
        leaf_done = is_leaf & (j_next >= count)
        advance = (~box_ok) | leaf_done | ~is_leaf
        node_next = torch.where(~box_ok | leaf_done, skip[nd],
                                torch.where(is_leaf, node, node + 1))
        j_next = torch.where(advance, 0, j_next)
        if any_hit:
            node_next = torch.where(idx >= 0, n_nodes, node_next)
        node = torch.where(active, node_next, node)
        j = torch.where(active, j_next, j)
    if stats is not None:
        stats["box_tests"] = stats.get("box_tests", 0) + int(n_box)
        stats["tri_tests"] = stats.get("tri_tests", 0) + int(n_tri)
    return t, idx.to(torch.int32)


def trace(bvh, tri, orig: Tensor, d: Tensor, t_max: Tensor | float = INF,
          any_hit: bool = False) -> tuple[Tensor, Tensor]:
    """Nearest-hit (or any-hit) traversal for a wavefront of rays.

    orig, d: (N, 3). t_max: scalar or (N,); hits beyond it are ignored and
    t_max <= 0 marks a dead lane. Returns (t (N,), tri_idx (N,) int32) with
    (INF, -1) on a miss. any_hit stops a ray at its first accepted hit."""
    return trace_arrays(bvh.aabb_min, bvh.aabb_max, bvh.first_tri,
                        bvh.tri_count, bvh.skip, triangle_constants(tri),
                        orig, d, t_max, any_hit)


def trace_bruteforce(tri, orig: Tensor, d: Tensor) -> tuple[Tensor, Tensor]:
    """O(N_rays * T) oracle: nearest hit over all triangles."""
    tc = triangle_constants(tri)
    n = orig.shape[0]
    t_best = torch.full((n,), INF, dtype=torch.float32, device=orig.device)
    idx = torch.full((n,), -1, dtype=torch.int32, device=orig.device)
    for i in range(tri.count):
        hit, t = ray_triangle_pre(
            orig[:, 0], orig[:, 1], orig[:, 2], d[:, 0], d[:, 1], d[:, 2],
            tc["n"][i, 0], tc["n"][i, 1], tc["n"][i, 2], tc["np0"][i],
            tc["t1"][i, 0], tc["t1"][i, 1], tc["t1"][i, 2], tc["t1w"][i],
            tc["t2"][i, 0], tc["t2"][i, 1], tc["t2"][i, 2], tc["t2w"][i])
        upd = hit & (t < t_best)
        t_best = torch.where(upd, t, t_best)
        idx = torch.where(upd, i, idx)
    return t_best, idx


def barycentrics(p: Tensor, p0: Tensor, p1: Tensor, p2: Tensor,
                 reference_quirks: bool = False) -> tuple[Tensor, Tensor, Tensor]:
    """Barycentric coordinates of point p in the triangle. Default: the
    robust 3D form; quirk mode: the reference's XY-plane projection."""
    if reference_quirks:
        denom_a = (-(p0[..., 0] - p1[..., 0]) * (p2[..., 1] - p1[..., 1])
                   + (p0[..., 1] - p1[..., 1]) * (p2[..., 0] - p1[..., 0]) + 1e-7)
        alpha = (-(p[..., 0] - p1[..., 0]) * (p2[..., 1] - p1[..., 1])
                 + (p[..., 1] - p1[..., 1]) * (p2[..., 0] - p1[..., 0])) / denom_a
        denom_b = (-(p1[..., 0] - p2[..., 0]) * (p0[..., 1] - p2[..., 1])
                   + (p1[..., 1] - p2[..., 1]) * (p0[..., 0] - p2[..., 0]) + 1e-7)
        beta = (-(p[..., 0] - p2[..., 0]) * (p0[..., 1] - p2[..., 1])
                + (p[..., 1] - p2[..., 1]) * (p0[..., 0] - p2[..., 0])) / denom_b
        return alpha, beta, 1.0 - alpha - beta
    e0 = p1 - p0
    e1 = p2 - p0
    ep = p - p0
    d00 = torch.sum(e0 * e0, dim=-1)
    d01 = torch.sum(e0 * e1, dim=-1)
    d11 = torch.sum(e1 * e1, dim=-1)
    d20 = torch.sum(ep * e0, dim=-1)
    d21 = torch.sum(ep * e1, dim=-1)
    denom = torch.clamp_min(d00 * d11 - d01 * d01, 1e-20)
    beta = (d11 * d20 - d01 * d21) / denom
    gamma = (d00 * d21 - d01 * d20) / denom
    return 1.0 - beta - gamma, beta, gamma
