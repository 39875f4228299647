"""The reference's closest-hit and any-hit search, without a BVH.

Triangles are put in Morton order of their centroids and cut into leaves
of LEAF triangles, and leaves into groups of GROUP leaves; each leaf and
group gets a box padded by a small margin. A ray tests every group box,
then the leaf boxes of the groups it enters, then every triangle of the
leaves it enters, with the program's triangle test (intersect.py). This
is a fixed two-level cull: the answer is the nearest accepted hit over all
triangles, whatever order the walk takes, with ties to the smallest
triangle index of the reference's own (file) order.

Hit semantics (tpuray_torch/integrator/intersect.py:trace_arrays): a hit
needs T_MIN <= t and t < t_max; t_max <= 0 marks a dead lane, which
returns (INF, -1); any_hit returns some accepted triangle.
"""
from __future__ import annotations

import torch

from portbench.reference.intersect import INF, ray_triangle_pre, safe_inv, triangle_constants

Tensor = torch.Tensor

LEAF = 16
GROUP = 32
PAIRS_PER_CHUNK = 1 << 20  # (ray, leaf) pairs tested at once


def _morton(q: Tensor) -> Tensor:
    """Interleaved bits of three 10-bit integer coordinates (int64)."""
    code = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


def _boxes(lo: Tensor, hi: Tensor, margin: float) -> tuple[Tensor, Tensor]:
    return lo - margin, hi + margin


class Clusters:
    """The two-level cull of triangles (T, 3) p0, p1, p2 (float32)."""

    def __init__(self, p0: Tensor, p1: Tensor, p2: Tensor):
        dev = p0.device
        t = p0.shape[0]
        c = (p0 + p1 + p2) / 3.0
        lo, hi = c.min(0).values, c.max(0).values
        q = ((c - lo) / torch.clamp_min(hi - lo, 1e-12) * 1023.0).long().clamp(0, 1023)
        order = torch.argsort(_morton(q))
        per_group = LEAF * GROUP
        n_groups = (t + per_group - 1) // per_group
        padded = n_groups * per_group
        ids = torch.full((padded,), -1, dtype=torch.int64, device=dev)
        ids[:t] = order
        self.tri_id = ids.view(n_groups * GROUP, LEAF)
        consts = triangle_constants(p0, p1, p2)
        rows = torch.zeros((padded, 12), dtype=torch.float32, device=dev)
        rows[:t] = consts[order]
        self.rows = rows.view(n_groups * GROUP, LEAF, 12)

        v = torch.stack([p0, p1, p2], 1)  # (T, 3, 3)
        vmin = torch.full((padded, 3), INF, dtype=torch.float32, device=dev)
        vmax = torch.full((padded, 3), -INF, dtype=torch.float32, device=dev)
        vmin[:t] = v.min(1).values[order]
        vmax[:t] = v.max(1).values[order]
        scene_lo = v.reshape(-1, 3).min(0).values
        scene_hi = v.reshape(-1, 3).max(0).values
        margin = float(1e-5 * (scene_hi - scene_lo).max() + 1e-6)
        leaf_lo = vmin.view(-1, LEAF, 3).min(1).values
        leaf_hi = vmax.view(-1, LEAF, 3).max(1).values
        self.leaf_lo, self.leaf_hi = _boxes(leaf_lo, leaf_hi, margin)
        self.group_lo, self.group_hi = _boxes(
            leaf_lo.view(n_groups, GROUP, 3).min(1).values,
            leaf_hi.view(n_groups, GROUP, 3).max(1).values, margin)


def _slab(o: Tensor, inv: Tensor, lo: Tensor, hi: Tensor, t_lim: Tensor) -> Tensor:
    """Whether the box overlaps (0, t_lim) along the ray."""
    f = (hi - o) * inv
    n = (lo - o) * inv
    t1 = torch.amin(torch.maximum(f, n), dim=-1)
    t0 = torch.amax(torch.minimum(f, n), dim=-1)
    return (t1 >= torch.clamp_min(t0, 0.0)) & (t0 < t_lim) & (t1 > 0.0)


@torch.no_grad()
def trace(cl: Clusters, orig: Tensor, d: Tensor, t_max: Tensor | float = INF,
          any_hit: bool = False, block: int = 1 << 15) -> tuple[Tensor, Tensor]:
    """(t (N,), triangle index (N,) int64) of N rays; (INF, -1) on a miss.
    Under any_hit, t is 0 where a triangle was accepted."""
    n = orig.shape[0]
    dev = orig.device
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    inv_all = safe_inv(d)
    live_rays = torch.nonzero(t_max > 0.0).flatten()
    # per (ray, leaf) pair tested: its nearest accepted t and, at that t,
    # the smallest triangle index
    row_ray, row_t, row_id = [], [], []
    for s in range(0, live_rays.numel(), block):
        rays = live_rays[s:s + block]
        o, inv, tm = orig[rays], inv_all[rays], t_max[rays]
        g_ok = _slab(o[:, None], inv[:, None], cl.group_lo[None], cl.group_hi[None],
                     tm[:, None])
        r, g = torch.nonzero(g_ok, as_tuple=True)
        leaves = g[:, None] * GROUP + torch.arange(GROUP, device=dev)
        l_ok = _slab(o[r][:, None], inv[r][:, None], cl.leaf_lo[leaves],
                     cl.leaf_hi[leaves], tm[r][:, None])
        pi, li = torch.nonzero(l_ok, as_tuple=True)
        pr, pl = rays[r[pi]], leaves[pi, li]
        for c in range(0, pr.numel(), PAIRS_PER_CHUNK):
            ray, ll = pr[c:c + PAIRS_PER_CHUNK], pl[c:c + PAIRS_PER_CHUNK]
            oq, dq = orig[ray], d[ray]
            hit, t = ray_triangle_pre(
                oq[:, 0:1], oq[:, 1:2], oq[:, 2:3], dq[:, 0:1], dq[:, 1:2], dq[:, 2:3],
                *cl.rows[ll].unbind(-1))
            ok = hit & (t < t_max[ray][:, None])
            t = torch.where(ok, t, INF)
            t_best = t.min(1).values
            ids = torch.where(ok & (t == t_best[:, None]), cl.tri_id[ll], _BIG)
            keep = t_best < INF
            row_ray.append(ray[keep])
            row_t.append(t_best[keep])
            row_id.append(ids.min(1).values[keep])
    t_out = torch.full((n,), INF, dtype=torch.float32, device=dev)
    i_out = torch.full((n,), _BIG, dtype=torch.int64, device=dev)
    if row_ray:
        ray, t, ids = torch.cat(row_ray), torch.cat(row_t), torch.cat(row_id)
        t_out.scatter_reduce_(0, ray, t, reduce="amin")
        at_min = t == t_out[ray]
        i_out.scatter_reduce_(0, ray[at_min], ids[at_min], reduce="amin")
    i_out = torch.where(t_out < INF, i_out, -1)
    if any_hit:
        t_out = torch.where(i_out >= 0, 0.0, INF)
    return t_out, i_out


_BIG = torch.iinfo(torch.int64).max
