"""The path-tracing integrator: 1spp progressive tracing with NEE.

Counterpart of tpuray/integrator/path_tracer.py: per bounce, resolve the
hit from (t, triangle index), sample the Disney BSDF (Sobol +
Cranley-Patterson + Wang-hash stream, in the JAX package's draw order),
draw the env-map and point-light NEE samples, and trace the bounce ray and
both shadow rays. `trace` picks the kernel as the JAX package's does:
a forest goes to K6 (kernels/trace_chunked.py), shared-origin rays on a
single tree to K1 and per-ray origins to K3 (kernels/trace.py). On a
single tree with cfg.fused_secondary each bounce's three walks are one K2
walk (trace_multi); otherwise, and always on a forest, they are separate
walks in the JAX package's order: env shadow, point shadow, bounce ray.
integrator="mis" hands the frame to integrator/mis.py. With
cfg.compact_frac > 0 the NEE integrator shades only the lanes whose primary
ray hit, packed densely into a buffer of compact_frac * N lanes (trace_paths).

Differentiable as the JAX package's is: the traversal is topology only (its
entries run under torch.no_grad, kernels/trace.py), resolve_hit detaches t
(the JAX package's stop_gradient), and every shading op after it carries
gradients to the material and light tables (train/optimize.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from tpuray_torch.integrator import disney
from tpuray_torch.integrator.disney import ShadeMaterial, safe_normalize
from tpuray_torch.integrator.gather_tables import (
    PackedScene, fetch_material, fetch_rows, fetch_tri, pack_scene_tables,
    tex_fetch, tex_fetch_packed)
from tpuray_torch.integrator.intersect import INF, barycentrics, cross
from tpuray_torch.kernels import trace as ktrace
from tpuray_torch.kernels import trace_chunked as ktc
from tpuray_torch.sampling import envmap as env
from tpuray_torch.sampling import rng
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.utils.metrics import count, span

Tensor = torch.Tensor
PI = np.float32(np.pi)
EPS = float(np.float32(1e-6))


def check_config(cfg: RenderConfig) -> None:
    """Raise for an integrator this port does not know."""
    if cfg.integrator not in ("nee", "mis"):
        raise ValueError(f"integrator={cfg.integrator!r}: 'nee' or 'mis'")


@dataclasses.dataclass(frozen=True)
class Tracer:
    """Which traversal the integrator calls: the kernel wrappers (which run
    the plain versions on CPU tensors) or the plain versions on any device
    (to compare a frame against on the card)."""

    packets: Callable  # K1: shared origin, single tree
    batched: Callable  # K3: per-ray origins, single tree
    multi: Callable    # K2: up to 3 classes from shared per-ray origins
    chunked: Callable  # K6: a forest


KERNELS = Tracer(packets=ktrace.trace_packets, batched=ktrace.trace_batched,
                 multi=ktrace.trace_multi, chunked=ktc.trace_chunked)
PLAIN = Tracer(packets=ktrace.trace_packets_plain,
               batched=ktrace.trace_packets_plain,
               multi=ktrace.trace_multi_plain,
               chunked=ktc.trace_chunked_plain)


def pack_traversal(scene) -> ktrace.TraceTables:
    """The scene's traversal tables: a forest's for K6, else a single
    tree's for K1-K3."""
    if scene.bvh.chunk_nodes:
        return ktc.pack_forest(scene.bvh, scene.triangles)
    return ktrace.pack_scene(scene.bvh, scene.triangles)


def trace(tracer: Tracer, tables: ktrace.TraceTables, orig: Tensor,
          d: Tensor, t_max: Tensor | float = INF, any_hit: bool = False,
          common_origin: bool = False) -> tuple[Tensor, Tensor]:
    """(t, idx) of N rays: a forest -> K6, a shared origin -> K1, per-ray
    origins -> K3 (tpuray/integrator/path_tracer.py:trace, without its
    fallback to the wavefront: every table goes to its kernel on the card).
    orig (N, 3), every row the same point when common_origin."""
    if tables.chunk_nodes:
        return tracer.chunked(tables, orig, d, t_max, any_hit, common_origin)
    if common_origin:
        return tracer.packets(tables, orig, d, t_max, any_hit, True)
    return tracer.batched(tables, orig, d, t_max, any_hit)


def resolve_aniso(scene, cfg: RenderConfig) -> bool:
    """RenderConfig.enable_aniso with "auto" resolved on the materials."""
    if cfg.enable_aniso != "auto":
        return bool(cfg.enable_aniso)
    return bool((scene.materials.anisotropic > 0.0).any())


def _abs(x: Tensor) -> Tensor:
    """|x| with jnp.abs's gradient: +1 at x == 0, where torch.abs passes 0
    (a metallic of 0, the common value, would learn nothing)."""
    if not disney.records_grad(x):
        return torch.abs(x)
    return torch.where(x >= 0.0, x, -x)


_ZERO = torch.tensor(0.0)  # a CPU scalar: usable beside tensors on any device


def clamp_light(light: Tensor, threshold: float) -> Tensor:
    """The final clamp, clip(light, 0, threshold), then the NaN scrub. With
    jnp.clip's gradient at the lower bound: half on a lane whose light is
    exactly 0 (a tie of maximum), where torch.clamp passes all of it."""
    if disney.records_grad(light):
        light = torch.minimum(torch.maximum(light, _ZERO),
                              torch.tensor(float(threshold)))
    else:
        light = torch.clamp(light, 0.0, threshold)
    return torch.where(torch.isnan(light), 0.0, light)


class Hit(NamedTuple):
    """What shading reads of a hit. (The JAX Hit's geometric normal has no
    reader.)"""

    valid: Tensor   # (N,) bool
    point: Tensor   # (N, 3)
    normal: Tensor  # (N, 3) shading normal, flipped toward the ray origin
    mat: ShadeMaterial


def _normal_mapped(pk: PackedScene, tri, ns: Tensor, uv: Tensor) -> Tensor:
    """The shading normal bent by the normal map (texture layer 2) through
    the triangle's tangent frame (tpuray/integrator/path_tracer.py:203-216)."""
    e1 = tri.p1 - tri.p0
    e2 = tri.p2 - tri.p0
    duv1 = tri.uv1 - tri.uv0
    duv2 = tri.uv2 - tri.uv0
    det = duv1[..., 0] * duv2[..., 1] - duv2[..., 0] * duv1[..., 1]
    f = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    tangent = f[..., None] * (duv2[..., 1:2] * e1 - duv1[..., 1:2] * e2)
    tangent = safe_normalize(tangent)
    bitangent = cross(tangent, ns)
    tex_n = tex_fetch(pk.tex_normal, tri.obj_id, uv) * 2.0 - 1.0
    tex_n = safe_normalize(tex_n)
    mapped = (tex_n[..., 0:1] * tangent + tex_n[..., 1:2] * bitangent
              + tex_n[..., 2:3] * ns)
    return safe_normalize(mapped)


def resolve_hit(pk: PackedScene, orig: Tensor, d: Tensor, t: Tensor,
                idx: Tensor, cfg: RenderConfig) -> Hit:
    """Hit point, shading normal and material from (t, triangle index). A
    negative base_color, metallic or roughness takes the texel of the
    scene's texture stack, and is clamped to its magnitude without one."""
    valid = idx >= 0
    i = torch.clamp_min(idx, 0)
    # topology only: no gradient through the hit distance; point keeps the
    # one through orig and d
    t = torch.where(valid, t, 1.0).detach()

    tri = fetch_tri(pk.tri_table, i)
    p0, p1, p2 = tri.p0, tri.p1, tri.p2
    point = orig + d * t[..., None]

    ng = safe_normalize(cross(p1 - p0, p2 - p0), eps=1e-30)
    inside = torch.sum(ng * d, dim=-1) > 0.0

    a, b, c = barycentrics(point, p0, p1, p2, cfg.reference_quirks)
    ns = a[..., None] * tri.n0 + b[..., None] * tri.n1 + c[..., None] * tri.n2
    ns = safe_normalize(ns, eps=1e-30)
    ns = torch.where(inside[..., None], -ns, ns)

    mat = fetch_material(pk.mat_table, tri.mat_id)
    if pk.tex_q is not None:
        uv = a[..., None] * tri.uv0 + b[..., None] * tri.uv1 + c[..., None] * tri.uv2
        obj = torch.clamp(tri.obj_id, 0, pk.tex_q.shape[0] - 1)
        tu = torch.clamp(uv[..., 0], 0.0, 1.0)
        tv = torch.clamp(1.0 - uv[..., 1], 0.0, 1.0)  # GL images are y-up
        texel = tex_fetch_packed(pk.tex_q, obj, tu, tv)
        base_neg = torch.any(mat.base_color < 0.0, dim=-1, keepdim=True)
        mat = mat._replace(
            base_color=torch.where(base_neg, texel[..., 0:3], mat.base_color),
            metallic=torch.where(mat.metallic < 0.0, texel[..., 3], mat.metallic),
            roughness=torch.where(mat.roughness < 0.0, texel[..., 4], mat.roughness))
        if cfg.use_normal_map:
            ns = _normal_mapped(pk, tri, ns, uv)
    else:
        # sentinels without a texture stack: clamp so shading stays sane
        mat = mat._replace(base_color=_abs(mat.base_color),
                           metallic=_abs(mat.metallic),
                           roughness=_abs(mat.roughness))
    return Hit(valid=valid, point=point, normal=ns, mat=mat)


def _env_nee_sample(pk: PackedScene, r1: Tensor, r2: Tensor
                    ) -> tuple[Tensor, Tensor, Tensor]:
    """Env-map light sample: (direction, radiance, pdf) from the NEE table."""
    return env.sample_env_nee(pk.env_nee_t, r1, r2)


def _env_nee_contrib(hit: Hit, v: Tensor, l: Tensor, radiance: Tensor,
                     p: Tensor, blocked: Tensor, pre: disney.ViewPre
                     ) -> tuple[Tensor, Tensor]:
    """Env NEE contribution given the shadow-ray outcome -> (contrib, pdf)."""
    f_r = disney.evaluate_pre(pre, v, hit.normal, l, hit.mat)
    p = torch.where(blocked, 0.0, p)
    p_safe = torch.where(blocked, 1.0, torch.clamp_min(p, 1e-12))
    contrib = (f_r * torch.abs(torch.sum(l * hit.normal, dim=-1))[..., None]
               * radiance / p_safe[..., None])
    contrib = torch.where(blocked[..., None], 0.0, contrib)
    return contrib, p


def _env_nee(pk: PackedScene, tables: ktrace.TraceTables, tracer: Tracer,
             hit: Hit, v: Tensor, r1: Tensor, r2: Tensor, active: Tensor,
             pre: disney.ViewPre) -> tuple[Tensor, Tensor]:
    """Env-map NEE with its own shadow walk (the separate-walk path). Dead
    lanes get t_max = 0; every consumer re-masks their outputs."""
    l, radiance, p = _env_nee_sample(pk, r1, r2)
    _, sidx = trace(tracer, tables, hit.point, l.contiguous(),
                    torch.where(active, INF, 0.0), any_hit=True)
    return _env_nee_contrib(hit, v, l, radiance, p, sidx >= 0, pre)


def _point_nee_sample(pk: PackedScene, hit: Hit, u: Tensor
                      ) -> tuple[Tensor, Tensor, Tensor]:
    """Point-light pick + direction -> (direction, distance, radiance)."""
    n_lights = pk.light_table.shape[0]
    li = torch.clamp_max((u * n_lights).to(torch.int64), n_lights - 1)
    lrow = fetch_rows(pk.light_table, li)
    lpos = lrow[..., 0:3]
    lrad = lrow[..., 3:6]
    delta = lpos - hit.point
    dist = torch.sqrt(torch.clamp_min(torch.sum(delta * delta, dim=-1), 1e-24))
    return delta / dist[..., None], dist, lrad


def _point_nee_contrib(n_lights: int, hit: Hit, v: Tensor, ldir: Tensor,
                       dist: Tensor, lrad: Tensor, shadowed: Tensor,
                       pre: disney.ViewPre) -> tuple[Tensor, Tensor]:
    """Point NEE contribution: pdf = 2 pi / n_lights, quadratic falloff."""
    pdf = torch.full(dist.shape, float(np.float32(2.0) * PI / np.float32(n_lights)),
                     dtype=torch.float32, device=dist.device)
    falloff = lrad / torch.clamp_min(dist * dist, 1e-12)[..., None]
    f_r = disney.evaluate_pre(pre, v, hit.normal, ldir, hit.mat)
    contrib = (falloff * f_r
               * torch.abs(torch.sum(ldir * hit.normal, dim=-1))[..., None]
               / pdf[..., None])
    contrib = torch.where(shadowed[..., None], 0.0, contrib)
    return contrib, pdf


def _point_nee(pk: PackedScene, tables: ktrace.TraceTables, tracer: Tracer,
               hit: Hit, v: Tensor, u: Tensor, active: Tensor,
               pre: disney.ViewPre) -> tuple[Tensor, Tensor]:
    """Point-light NEE with its own shadow walk (the separate-walk path);
    no walk without lights."""
    n_lights = pk.light_table.shape[0]
    if n_lights == 0:
        return (torch.zeros_like(hit.point),
                torch.zeros(hit.point.shape[:-1], dtype=torch.float32,
                            device=hit.point.device))
    ldir, dist, lrad = _point_nee_sample(pk, hit, u)
    _, sidx = trace(tracer, tables, hit.point, ldir,
                    torch.where(active, dist, 0.0), any_hit=True)
    return _point_nee_contrib(n_lights, hit, v, ldir, dist, lrad, sidx >= 0,
                              pre)


def _use_fused_secondary(tables: ktrace.TraceTables, cfg: RenderConfig) -> bool:
    """One K2 walk per bounce: a single tree with cfg.fused_secondary. A
    forest always takes the separate walks (as in the JAX package)."""
    return cfg.fused_secondary and not tables.chunk_nodes


class PTOutput(NamedTuple):
    color: Tensor            # (N, 3) per-ray radiance (1 spp)
    emission: Tensor         # (N, 3) first-hit emissive
    albedo: Tensor           # (N, 3) first-hit base color
    first_hit_t: Tensor      # (N,) primary traversal t (INF = sky)
    first_hit_valid: Tensor  # (N,) bool
    first_hit_point: Tensor  # (N, 3)
    first_hit_normal: Tensor  # (N, 3)


class _ShadeOut(NamedTuple):
    light: Tensor
    miss_any: Tensor
    miss_dir: Tensor
    miss_reduction: Tensor
    emission0: Tensor
    albedo0: Tensor
    valid0: Tensor
    point0: Tensor
    normal0: Tensor


def _shade_loop(pk: PackedScene, tables: ktrace.TraceTables,
                tracer: Tracer, cfg: RenderConfig, orig: Tensor,
                d: Tensor, px: Tensor, py: Tensor, frame: int,
                first_t: Tensor, first_idx: Tensor, coherent: bool,
                aniso: bool) -> _ShadeOut:
    """The per-bounce NEE + BSDF loop, with the bounce-0 traversal given.
    Every sample stream is keyed on (px, py, frame), never on lane position."""
    n = d.shape[0]
    dev = d.device
    seed = rng.pixel_seed(px, py, frame)
    # the reference draws (and discards) an AA jitter first
    _, seed = rng.rand(seed)
    _, seed = rng.rand(seed)

    if coherent:
        # one secondary-ray stream per 32x32 screen tile (see RenderConfig)
        tpx = px.to(torch.int64) // 32 + 0x8000
        tpy = py.to(torch.int64) // 32 + 0x8000
        tseed = rng.pixel_seed(tpx, tpy, frame)
        cpr_u, cpr_v = rng.cranley_patterson_offsets(tpx, tpy)
    else:
        cpr_u, cpr_v = rng.cranley_patterson_offsets(px, py)

    def z3():
        return torch.zeros((n, 3), dtype=torch.float32, device=dev)

    light = z3()
    reduction = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    # each ray misses at most once: record (direction, throughput) and fetch
    # the environment once after the loop
    miss_any = torch.zeros(n, dtype=torch.bool, device=dev)
    miss_dir = d
    miss_reduction = z3()
    emission0, albedo0, point0, normal0 = z3(), z3(), z3(), z3()
    valid0 = torch.zeros(n, dtype=torch.bool, device=dev)
    n_lights = pk.light_table.shape[0]
    fused = _use_fused_secondary(tables, cfg)

    t, idx = first_t, first_idx
    for bounce in range(cfg.max_tracing_depth):
        last = bounce == cfg.max_tracing_depth - 1
        hit = resolve_hit(pk, orig, d, t, idx, cfg)

        if bounce == 0:
            vmask = hit.valid[..., None]
            emission0 = torch.where(vmask, hit.mat.emissive, 0.0)
            albedo0 = torch.where(vmask, hit.mat.base_color, 0.0)
            valid0 = hit.valid
            point0 = torch.where(vmask, hit.point, 0.0)
            normal0 = torch.where(vmask, hit.normal, 0.0)

        miss = alive & ~hit.valid
        miss_dir = torch.where(miss[..., None], d, miss_dir)
        miss_reduction = torch.where(miss[..., None], reduction, miss_reduction)
        miss_any = miss_any | miss
        alive = alive & hit.valid

        # BSDF sample (Sobol + CPR + stream xi3)
        sob = rng.sobol_vec2(frame + 1, bounce)
        xi1, xi2 = rng.cranley_patterson_rotate(sob, cpr_u, cpr_v)
        if coherent:
            xi3, tseed = rng.rand(tseed)
        else:
            xi3, seed = rng.rand(seed)

        v = -d
        tb = disney.build_onb(hit.normal) if aniso else None
        l_new = disney.sample(xi1, xi2, xi3, v, hit.normal, hit.mat, frame=tb)
        ndotl = torch.sum(hit.normal * l_new, dim=-1)
        alive = alive & (ndotl > 0.0)

        pre = disney.precompute_view(v, hit.normal, hit.mat, frame=tb)
        f_r, brdf_pdf = disney.evaluate_pdf_pre(pre, v, hit.normal, l_new,
                                                hit.mat)
        if coherent:
            er1, tseed = rng.rand(tseed)
            er2, tseed = rng.rand(tseed)
            lu, tseed = rng.rand(tseed)
        else:
            er1, seed = rng.rand(seed)
            er2, seed = rng.rand(seed)
            lu, seed = rng.rand(seed)

        if fused:
            # ONE walk (K2) for this bounce's classes, all from hit.point: the
            # bounce ray (closest hit, not on the last bounce), the env shadow
            # and the point shadow (any hit). Dead lanes get t_max = 0.
            l_env, env_rad, env_p = _env_nee_sample(pk, er1, er2)
            act_inf = torch.where(alive, INF, 0.0)
            dirs, tms, ah = [l_env.contiguous()], [act_inf], [True]
            if n_lights:
                ldir, ldist, lrad = _point_nee_sample(pk, hit, lu)
                dirs.append(ldir)
                tms.append(torch.where(alive, ldist, 0.0))
                ah.append(True)
            if not last:
                dirs.insert(0, l_new)
                tms.insert(0, act_inf)
                ah.insert(0, False)
            res = tracer.multi(tables, hit.point, dirs, tms, ah)
            ci = 0
            if not last:
                t_next, idx_next = res[0]
                ci = 1
            env_c, env_pdf_v = _env_nee_contrib(
                hit, v, l_env, env_rad, env_p, res[ci][1] >= 0, pre)
            if n_lights:
                pt_c, pt_pdf_v = _point_nee_contrib(
                    n_lights, hit, v, ldir, ldist, lrad, res[ci + 1][1] >= 0,
                    pre)
            else:
                pt_c = z3()
                pt_pdf_v = torch.zeros(n, dtype=torch.float32, device=dev)
        else:
            env_c, env_pdf_v = _env_nee(pk, tables, tracer, hit, v, er1, er2,
                                        alive, pre)
            pt_c, pt_pdf_v = _point_nee(pk, tables, tracer, hit, v, lu, alive,
                                        pre)

        cos_term = torch.abs(ndotl)[..., None]
        brdf_c = (hit.mat.emissive * f_r * cos_term
                  / torch.clamp_min(brdf_pdf, 1e-12)[..., None])
        wsum = env_pdf_v + pt_pdf_v + brdf_pdf + EPS
        hit_light = reduction * (
            (env_pdf_v / wsum)[..., None] * env_c
            + (pt_pdf_v / wsum)[..., None] * pt_c
            + (brdf_pdf / wsum)[..., None] * brdf_c)
        light = light + torch.where(alive[..., None], hit_light, 0.0)

        reduction = reduction * torch.where(
            alive[..., None],
            f_r * cos_term / torch.clamp_min(brdf_pdf, 1e-12)[..., None], 1.0)

        orig = hit.point
        d = torch.where(alive[..., None], l_new, d)
        if not last:
            if fused:
                t, idx = t_next, idx_next
            else:
                # terminated paths stop paying for traversal: t_max = 0
                t, idx = trace(tracer, tables, orig, d,
                               torch.where(alive, INF, 0.0))

    return _ShadeOut(light=light, miss_any=miss_any, miss_dir=miss_dir,
                     miss_reduction=miss_reduction, emission0=emission0,
                     albedo0=albedo0, valid0=valid0, point0=point0,
                     normal0=normal0)


def _compact_budget(n: int, cfg: RenderConfig) -> int:
    """Compacted-wavefront size: compact_frac * n rounded up to 512 lanes;
    0 (no compaction) when that is not below n."""
    if cfg.compact_frac <= 0.0:
        return 0
    budget = (int(n * cfg.compact_frac) + 511) // 512 * 512
    if budget <= 0 or budget >= n:
        return 0
    return budget


def host_count(hits: Tensor) -> int:
    """A device count read on the host: the one read of a frame, the number
    of primary hits, which decides whether the residual pass runs. It waits
    for the primary trace."""
    with span("tpuray.wait.hit_count"):
        return int(hits)


def _merge_residual(out: _ShadeOut, r: _ShadeOut, r_alive: Tensor) -> _ShadeOut:
    """The compacted pass's outputs with the residual pass's added. Lanes the
    residual pass masked off report a bounce-0 miss, which is scrubbed (it
    would hand them a second env contribution)."""
    mm = r.miss_any & r_alive
    return _ShadeOut(
        light=out.light + r.light, miss_any=out.miss_any | mm,
        miss_dir=torch.where(mm[..., None], r.miss_dir, out.miss_dir),
        miss_reduction=torch.where(mm[..., None], r.miss_reduction,
                                   out.miss_reduction),
        emission0=out.emission0 + r.emission0, albedo0=out.albedo0 + r.albedo0,
        valid0=out.valid0 | r.valid0, point0=out.point0 + r.point0,
        normal0=out.normal0 + r.normal0)


def _shade_compacted(pk: PackedScene, tables: ktrace.TraceTables,
                     tracer: Tracer, cfg: RenderConfig, orig: Tensor,
                     d: Tensor, px: Tensor, py: Tensor, frame: int,
                     t0: Tensor, idx0: Tensor, budget: int, aniso: bool
                     ) -> _ShadeOut:
    """_shade_loop over the first `budget` lanes whose primary ray hit, in
    tile order, then scattered back (tpuray/integrator/path_tracer.py:
    600-695). Padding lanes (fewer hits than the budget) trace as misses and
    are masked at the scatter. Sample streams are keyed on pixel, never on
    lane, so every pixel gets the uncompacted loop's math. When more lanes
    hit than the budget, a residual full-width pass shades the rest."""
    n = d.shape[0]
    dev = d.device
    coherent = cfg.tile_coherent_sampling
    alive0 = idx0 >= 0
    rank = torch.cumsum(alive0.to(torch.int32), 0) - 1
    in_sel = alive0 & (rank < budget)
    # sel[k] = the lane of rank k, without a host sync: each selected lane
    # writes its id to slot rank, the others to a dropped slot budget;
    # slots past the hit count keep lane 0 (masked by lane_ok)
    slot = torch.where(in_sel, rank.to(torch.int64), budget)
    sel = torch.zeros(budget + 1, dtype=torch.int64, device=dev).scatter_(
        0, slot, torch.arange(n, device=dev))[:budget]
    n_alive = rank[-1] + 1
    lane_ok = torch.arange(budget, device=dev) < n_alive

    # one gather per dtype
    gf = torch.cat([orig, d, t0[:, None]], dim=1)[sel]
    gi = torch.stack([px.to(torch.int64), py.to(torch.int64),
                      idx0.to(torch.int64)], dim=1)[sel]
    c_d = gf[:, 3:6]
    c = _shade_loop(
        pk, tables, tracer, cfg, gf[:, 0:3], c_d, gi[:, 0].to(px.dtype),
        gi[:, 1].to(py.dtype), frame, torch.where(lane_ok, gf[:, 6], INF),
        torch.where(lane_ok, gi[:, 2], -1).to(idx0.dtype),
        # tile keying is pixel-derived (px // 32), never lane position
        coherent, aniso)

    # one scatter of every per-lane output; miss_dir goes as a delta on d so
    # that lanes that never miss keep a unit direction (a zero one would NaN
    # the env fetch's normalisation, and its gradient)
    packed = torch.cat([
        c.light, c.emission0, c.albedo0, c.point0, c.normal0,
        c.miss_dir - c_d,
        torch.where(c.miss_any[..., None], c.miss_reduction, 0.0),
        c.valid0[..., None].to(torch.float32),
        c.miss_any[..., None].to(torch.float32)], dim=1)
    scattered = torch.zeros((n, 23), dtype=torch.float32, device=dev).index_add(
        0, sel, torch.where(lane_ok[..., None], packed, 0.0))
    # primary misses are never selected: they miss at bounce 0 with
    # throughput 1
    out = _ShadeOut(
        light=scattered[:, 0:3], emission0=scattered[:, 3:6],
        albedo0=scattered[:, 6:9], point0=scattered[:, 9:12],
        normal0=scattered[:, 12:15], miss_dir=d + scattered[:, 15:18],
        miss_reduction=torch.where((~alive0)[..., None], 1.0, scattered[:, 18:21]),
        valid0=scattered[:, 21] > 0.5,
        miss_any=(scattered[:, 22] > 0.5) | ~alive0)

    if host_count(n_alive) <= budget:
        count("shaded_lanes", budget)
        return out
    count("shaded_lanes", budget + n)
    count("residual", True)
    r_alive = alive0 & ~in_sel
    r = _shade_loop(pk, tables, tracer, cfg, orig, d, px, py, frame,
                    torch.where(r_alive, t0, INF), torch.where(r_alive, idx0, -1),
                    coherent, aniso)
    return _merge_residual(out, r, r_alive)


def trace_paths(scene, orig: Tensor, d: Tensor, px: Tensor, py: Tensor,
                frame: int, cfg: RenderConfig, common_origin: bool = False,
                tracer: Tracer = KERNELS,
                tables: ktrace.TraceTables | None = None,
                pk: PackedScene | None = None) -> PTOutput:
    """One sample per ray, up to cfg.max_tracing_depth bounces.

    orig/d: (N, 3) (orig may be (1, 3) or an expanded view when
    common_origin: every ray shares one origin); px/py: (N,) integer global
    pixel coords (the RNG keys); frame: int. tables/pk: the scene's packed
    traversal (pack_traversal) and shading tables, built here when not
    given.

    cfg.compact_frac > 0 shades only the lanes that hit, at
    _compact_budget(N) lanes (_shade_compacted): per pixel the same math,
    so the same result up to the order of float operations. The residual
    pass that keeps a frame exact when more lanes hit than the budget is a
    host branch on the hit count, the one value a frame reads back."""
    with span("tpuray.trace_paths"):
        check_config(cfg)
        n = d.shape[0]
        orig = orig.expand(n, 3)
        pk = pack_scene_tables(scene) if pk is None else pk
        tables = pack_traversal(scene) if tables is None else tables
        aniso = resolve_aniso(scene, cfg)
        count("frame_idx", int(frame))
        count("lanes", n)
        if cfg.integrator == "mis":
            from tpuray_torch.integrator.mis import trace_paths_mis
            count("shaded_lanes", n)
            return trace_paths_mis(pk, tables, tracer, orig, d, px, py,
                                   int(frame), cfg, common_origin, aniso)

        t0, idx0 = trace(tracer, tables, orig, d, INF,
                         common_origin=common_origin)
        budget = _compact_budget(n, cfg)
        if budget:
            out = _shade_compacted(pk, tables, tracer, cfg, orig, d, px, py,
                                   int(frame), t0, idx0, budget, aniso)
        else:
            count("shaded_lanes", n)
            out = _shade_loop(pk, tables, tracer, cfg, orig, d, px, py, int(frame),
                              t0, idx0, cfg.tile_coherent_sampling, aniso)

        env_rad = env.env_radiance(pk.env_image, out.miss_dir)
        light = out.light + torch.where(out.miss_any[..., None],
                                        env_rad * out.miss_reduction, 0.0)
        light = clamp_light(light, cfg.clamp_threshold)

        return PTOutput(color=light, emission=out.emission0, albedo=out.albedo0,
                        first_hit_t=t0, first_hit_valid=out.valid0,
                        first_hit_point=out.point0,
                        first_hit_normal=out.normal0)
