"""The triangle test, its constants and barycentrics: frozen copies of
tpuray_torch/integrator/intersect.py's cross, triangle_constants,
ray_triangle_pre, safe_inv and barycentrics, in the same float op order,
so that the reference's hit distance of a ray on a triangle equals the
program's bit for bit. The walk that finds the triangles is the
reference's own (trace.py).
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

INF = float(np.float32(1e30))
T_MIN = float(np.float32(5e-4))
PARALLEL_EPS = float(np.float32(1e-5))


def cross(a: Tensor, b: Tensor) -> Tensor:
    """Cross product over the last axis."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def norm(v: Tensor, keepdim: bool = True) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def triangle_constants(p0: Tensor, p1: Tensor, p2: Tensor) -> Tensor:
    """(T, 12) rows [n xyz, n.p0, T1 xyz, t1w, T2 xyz, t2w]: the plane and
    two barycentric plane transforms of each triangle. Degenerate
    triangles (zero rows) never hit."""
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
    np0 = torch.sum(n * p0, dim=-1)
    t1w = -torch.sum(t1 * p0, dim=-1) * zero[..., 0]
    t2w = -torch.sum(t2 * p0, dim=-1) * zero[..., 0]
    return torch.cat([n, np0[:, None], t1, t1w[:, None], t2, t2w[:, None]], 1)


def ray_triangle_pre(ox, oy, oz, dx, dy, dz,
                     nx, ny, nz, np0, t1x, t1y, t1z, t1w,
                     t2x, t2y, t2z, t2w) -> tuple[Tensor, Tensor]:
    """Scalarized precomputed triangle test -> (hit, t)."""
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


def safe_inv(d: Tensor) -> Tensor:
    """1/d with |d| < 1e-20 clamped to +-1e-20 (sign kept)."""
    tiny = torch.where(d < 0, -1e-20, 1e-20)
    return 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)


def barycentrics(p: Tensor, p0: Tensor, p1: Tensor, p2: Tensor
                 ) -> tuple[Tensor, Tensor, Tensor]:
    """Barycentric coordinates of point p in the triangle: the robust 3D
    form."""
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
