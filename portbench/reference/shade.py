"""The reference integrator: 1 sample per pixel, NEE of the env map and the
point lights, Disney BSDF bounces, up to cfg.max_tracing_depth.

The shading is tpuray_torch/integrator/path_tracer.py's uncompacted NEE
loop (_shade_loop with separate walks, trace_paths), frozen here with its
float op order, sample streams keyed on (pixel, frame) and gradient
helpers: the walks are the reference's own (trace.py), every lane is
shaded (no compaction: the program's compaction is per pixel the same
math), and the tables are built here from the reference's own scene
(scene.py), never taken from the program.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import disney, rng
from portbench.reference import envmap as env
from portbench.reference.config import RenderConfig
from portbench.reference.disney import ShadeMaterial, safe_normalize
from portbench.reference.intersect import INF, barycentrics, cross
from portbench.reference.trace import Clusters, trace

Tensor = torch.Tensor
EPS = float(np.float32(1e-6))
INV_255 = float(np.float32(1.0 / 255.0))
MATERIAL_FIELDS = ("emissive", "base_color", "subsurface", "metallic", "specular",
                   "specular_tint", "roughness", "anisotropic", "sheen", "sheen_tint",
                   "clearcoat", "clearcoat_gloss", "ior", "transmission")


@dataclasses.dataclass
class RefScene:
    """The reference's scene on a device: triangles in file order with their
    attributes, the cull (trace.Clusters), materials and lights as dicts of
    tensors (the trainable leaves), the env map with its NEE table and its
    inverse-CDF cache (MIS samples and weighs the env map by it), and the
    texture stack's bf16 combined map."""

    tri: Tensor          # (T, 26) [p0 p1 p2 n0 n1 n2 uv0 uv1 uv2 mat obj]
    clusters: Clusters
    materials: dict      # field -> (M,) or (M, 3)
    lights: dict         # "position", "radiance" -> (L, 3)
    env_image: Tensor
    env_nee_t: Tensor
    env_cache: Tensor
    tex_q: Tensor | None
    tex_normal: Tensor | None

    def replace(self, **kw) -> "RefScene":
        return dataclasses.replace(self, **kw)


def material_rows(m: dict) -> Tensor:
    """(M, 18) rows in the program's shading layout."""
    cols = [m["emissive"], m["base_color"]]
    cols += [m[k][:, None] for k in MATERIAL_FIELDS[2:]]
    return torch.cat(cols, dim=-1)


def fetch_material(rows: Tensor, mat_id: Tensor) -> ShadeMaterial:
    row = rows[mat_id]
    return ShadeMaterial(
        emissive=row[..., 0:3], base_color=row[..., 3:6],
        subsurface=row[..., 6], metallic=row[..., 7], specular=row[..., 8],
        specular_tint=row[..., 9], roughness=row[..., 10],
        sheen=row[..., 12], sheen_tint=row[..., 13], clearcoat=row[..., 14],
        clearcoat_gloss=row[..., 15], anisotropic=row[..., 11])


def _bilinear_taps(h: int, w: int, u: Tensor, v: Tensor):
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    x1i = torch.clamp_max(x0i + 1, w - 1)
    y1i = torch.clamp_max(y0i + 1, h - 1)
    return y0i, y1i, x0i, x1i, fx, fy


def _bilinear(c00, c10, c01, c11, fx, fy):
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy


def tex_fetch_packed(tex_q: Tensor, obj: Tensor, u: Tensor, v: Tensor) -> Tensor:
    """Bilinear fetch of the bf16 combined map (texels * 255) -> (N, 5)."""
    _, h, w, _ = tex_q.shape
    y0, y1, x0, x1, fx, fy = _bilinear_taps(h, w, u, v)

    def tap(y, x):
        return tex_q[obj, y, x].to(torch.float32) * INV_255
    return _bilinear(tap(y0, x0), tap(y0, x1), tap(y1, x0), tap(y1, x1), fx, fy)


def _abs(x: Tensor) -> Tensor:
    """|x| with a gradient of +1 at 0."""
    if not disney.records_grad(x):
        return torch.abs(x)
    return torch.where(x >= 0.0, x, -x)


_ZERO = torch.tensor(0.0)


def clamp_light(light: Tensor, threshold: float) -> Tensor:
    """clip(light, 0, threshold) with half the gradient at a tie at 0, then
    the NaN scrub."""
    if disney.records_grad(light):
        light = torch.minimum(torch.maximum(light, _ZERO), torch.tensor(float(threshold)))
    else:
        light = torch.clamp(light, 0.0, threshold)
    return torch.where(torch.isnan(light), 0.0, light)


class Hit(NamedTuple):
    valid: Tensor
    point: Tensor
    normal: Tensor
    mat: ShadeMaterial


def resolve_hit(scene: RefScene, mat_rows: Tensor, orig: Tensor, d: Tensor, t: Tensor,
                idx: Tensor, cfg: RenderConfig) -> Hit:
    """Hit point, shading normal (flipped toward the ray) and material; the
    texture stack replaces negative base_color, metallic and roughness."""
    if cfg.use_normal_map:
        raise NotImplementedError("the reference has no normal map")
    valid = idx >= 0
    row = scene.tri[torch.clamp_min(idx, 0)]
    t = torch.where(valid, t, 1.0).detach()
    p0, p1, p2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    point = orig + d * t[..., None]
    ng = safe_normalize(cross(p1 - p0, p2 - p0), eps=1e-30)
    inside = torch.sum(ng * d, dim=-1) > 0.0
    a, b, c = barycentrics(point, p0, p1, p2)
    ns = a[..., None] * row[..., 9:12] + b[..., None] * row[..., 12:15] + c[..., None] * row[..., 15:18]
    ns = safe_normalize(ns, eps=1e-30)
    ns = torch.where(inside[..., None], -ns, ns)
    mat_id = row[..., 24].to(torch.int64)
    obj_id = row[..., 25].to(torch.int64)
    mat = fetch_material(mat_rows, mat_id)
    if scene.tex_q is not None:
        uv = a[..., None] * row[..., 18:20] + b[..., None] * row[..., 20:22] + c[..., None] * row[..., 22:24]
        obj = torch.clamp(obj_id, 0, scene.tex_q.shape[0] - 1)
        tu = torch.clamp(uv[..., 0], 0.0, 1.0)
        tv = torch.clamp(1.0 - uv[..., 1], 0.0, 1.0)
        texel = tex_fetch_packed(scene.tex_q, obj, tu, tv)
        base_neg = torch.any(mat.base_color < 0.0, dim=-1, keepdim=True)
        mat = mat._replace(
            base_color=torch.where(base_neg, texel[..., 0:3], mat.base_color),
            metallic=torch.where(mat.metallic < 0.0, texel[..., 3], mat.metallic),
            roughness=torch.where(mat.roughness < 0.0, texel[..., 4], mat.roughness))
    else:
        mat = mat._replace(base_color=_abs(mat.base_color), metallic=_abs(mat.metallic),
                           roughness=_abs(mat.roughness))
    return Hit(valid=valid, point=point, normal=ns, mat=mat)


def resolve_aniso(scene: RefScene, cfg: RenderConfig) -> bool:
    """cfg.enable_aniso with "auto" resolved on the materials."""
    if cfg.enable_aniso == "auto":
        return bool((scene.materials["anisotropic"] > 0.0).any())
    return bool(cfg.enable_aniso)


class PathOut(NamedTuple):
    color: Tensor     # (N, 3) clamped 1-spp radiance
    emission: Tensor  # (N, 3) first-hit emissive
    albedo: Tensor    # (N, 3) first-hit base color
    valid: Tensor     # (N,) primary hit
    point: Tensor     # (N, 3)
    normal: Tensor    # (N, 3)


def trace_paths(scene: RefScene, eye: Tensor, d: Tensor, px: Tensor, py: Tensor,
                frame: int, cfg: RenderConfig) -> PathOut:
    """One sample per ray from the shared origin `eye` (3,): NEE here, MIS
    in mis.py."""
    if cfg.tile_coherent_sampling:
        raise NotImplementedError("the reference samples per pixel")
    if cfg.integrator == "mis":
        from portbench.reference.mis import trace_paths_mis
        return trace_paths_mis(scene, eye, d, px, py, frame, cfg)
    if cfg.integrator != "nee":
        raise NotImplementedError(f"integrator={cfg.integrator!r}")
    n = d.shape[0]
    dev = d.device
    orig = eye[None].expand(n, 3)
    mat_rows = material_rows(scene.materials)
    light_rows = torch.cat([scene.lights["position"], scene.lights["radiance"]], -1)
    n_lights = light_rows.shape[0]
    aniso = resolve_aniso(scene, cfg)
    t, idx = trace(scene.clusters, orig, d, INF)

    seed = rng.pixel_seed(px, py, frame)
    _, seed = rng.rand(seed)  # the discarded AA jitter
    _, seed = rng.rand(seed)
    cpr_u, cpr_v = rng.cranley_patterson_offsets(px, py)

    def z3():
        return torch.zeros((n, 3), dtype=torch.float32, device=dev)

    light = z3()
    reduction = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    miss_any = torch.zeros(n, dtype=torch.bool, device=dev)
    miss_dir = d
    miss_reduction = z3()
    emission0 = albedo0 = point0 = normal0 = z3()
    valid0 = torch.zeros(n, dtype=torch.bool, device=dev)

    for bounce in range(cfg.max_tracing_depth):
        last = bounce == cfg.max_tracing_depth - 1
        hit = resolve_hit(scene, mat_rows, orig, d, t, idx, cfg)
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

        sob = rng.sobol_vec2(frame + 1, bounce)
        xi1, xi2 = rng.cranley_patterson_rotate(sob, cpr_u, cpr_v)
        xi3, seed = rng.rand(seed)
        v = -d
        tb = disney.build_onb(hit.normal) if aniso else None
        l_new = disney.sample(xi1, xi2, xi3, v, hit.normal, hit.mat, frame=tb)
        ndotl = torch.sum(hit.normal * l_new, dim=-1)
        alive = alive & (ndotl > 0.0)
        pre = disney.precompute_view(v, hit.normal, hit.mat, frame=tb)
        f_r, brdf_pdf = disney.evaluate_pdf_pre(pre, v, hit.normal, l_new, hit.mat)
        er1, seed = rng.rand(seed)
        er2, seed = rng.rand(seed)
        lu, seed = rng.rand(seed)

        # env NEE: its shadow ray, any hit; dead lanes trace nothing
        l_env, env_rad, env_p = env.sample_env_nee(scene.env_nee_t, er1, er2)
        _, sidx = trace(scene.clusters, hit.point, l_env.contiguous(),
                        torch.where(alive, INF, 0.0), any_hit=True)
        blocked = sidx >= 0
        f_env = disney.evaluate_pre(pre, v, hit.normal, l_env, hit.mat)
        env_pdf_v = torch.where(blocked, 0.0, env_p)
        p_safe = torch.where(blocked, 1.0, torch.clamp_min(env_pdf_v, 1e-12))
        env_c = (f_env * torch.abs(torch.sum(l_env * hit.normal, dim=-1))[..., None]
                 * env_rad / p_safe[..., None])
        env_c = torch.where(blocked[..., None], 0.0, env_c)

        # point-light NEE
        if n_lights:
            li = torch.clamp_max((lu * n_lights).to(torch.int64), n_lights - 1)
            lrow = light_rows[li]
            delta = lrow[..., 0:3] - hit.point
            dist = torch.sqrt(torch.clamp_min(torch.sum(delta * delta, dim=-1), 1e-24))
            ldir = delta / dist[..., None]
            _, pidx = trace(scene.clusters, hit.point, ldir,
                            torch.where(alive, dist, 0.0), any_hit=True)
            pt_pdf_v = torch.full(dist.shape, float(np.float32(2.0) * disney.PI
                                                    / np.float32(n_lights)),
                                  dtype=torch.float32, device=dev)
            falloff = lrow[..., 3:6] / torch.clamp_min(dist * dist, 1e-12)[..., None]
            f_pt = disney.evaluate_pre(pre, v, hit.normal, ldir, hit.mat)
            pt_c = (falloff * f_pt
                    * torch.abs(torch.sum(ldir * hit.normal, dim=-1))[..., None]
                    / pt_pdf_v[..., None])
            pt_c = torch.where((pidx >= 0)[..., None], 0.0, pt_c)
        else:
            pt_c = z3()
            pt_pdf_v = torch.zeros(n, dtype=torch.float32, device=dev)

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
            t, idx = trace(scene.clusters, orig, d, torch.where(alive, INF, 0.0))

    env_rad = env.env_radiance(scene.env_image, miss_dir)
    light = light + torch.where(miss_any[..., None], env_rad * miss_reduction, 0.0)
    light = clamp_light(light, cfg.clamp_threshold)
    return PathOut(color=light, emission=emission0, albedo=albedo0, valid=valid0,
                   point=point0, normal=normal0)
