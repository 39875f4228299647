"""The reference's MIS integrator (RenderConfig.integrator="mis"): 1 sample
per pixel, per bounce an env-map light sample and a BSDF sample combined
with the squared balance heuristic; point lights are not part of it.

tpuray_torch/integrator/mis.py's per-pixel loop, frozen here walk for walk
and expression for expression, as shade.py freezes the NEE loop: the
bounce-0 primaries from the shared origin, then per bounce the light
arm's shadow walk (any hit) and the BSDF arm's continuation walk, and
from bounce 1 on the bounce's own walk, which repeats the previous
bounce's continuation ray as the program does. The walks are the
reference's own (trace.py), and every table comes from the reference's
own scene (scene.py): the env map's inverse-CDF cache included.
"""
from __future__ import annotations

import torch

from portbench.reference import disney, rng
from portbench.reference import envmap as env
from portbench.reference.config import RenderConfig
from portbench.reference.intersect import INF
from portbench.reference.shade import (PathOut, RefScene, clamp_light, fetch_material,
                                       material_rows, resolve_aniso, resolve_hit)
from portbench.reference.trace import trace

Tensor = torch.Tensor


def mis_mix_weight(a: Tensor, b: Tensor) -> Tensor:
    """Squared balance heuristic a^2 / (a^2 + b^2)."""
    t = a * a
    return t / torch.clamp_min(b * b + t, 1e-20)


def trace_paths_mis(scene: RefScene, eye: Tensor, d: Tensor, px: Tensor, py: Tensor,
                    frame: int, cfg: RenderConfig) -> PathOut:
    """One MIS sample per ray from the shared origin `eye` (3,), per pixel
    (shade.trace_paths refuses tile_coherent_sampling)."""
    n = d.shape[0]
    dev = d.device
    orig = eye[None].expand(n, 3)
    mat_rows = material_rows(scene.materials)
    aniso = resolve_aniso(scene, cfg)
    seed = rng.pixel_seed(px, py, frame)
    _, seed = rng.rand(seed)  # the discarded AA jitter
    _, seed = rng.rand(seed)
    cpr_u, cpr_v = rng.cranley_patterson_offsets(px, py)

    def z3():
        return torch.zeros((n, 3), dtype=torch.float32, device=dev)

    light = z3()
    history = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    emission0 = albedo0 = point0 = normal0 = z3()
    valid0 = torch.zeros(n, dtype=torch.bool, device=dev)

    for bounce in range(cfg.max_tracing_depth):
        # terminated paths get t_max = 0 and cost no walk
        b_tmax = INF if bounce == 0 else torch.where(alive, INF, 0.0)
        t, idx = trace(scene.clusters, orig, d, b_tmax)
        hit = resolve_hit(scene, mat_rows, orig, d, t, idx, cfg)

        if bounce == 0:
            vmask = hit.valid[..., None]
            emission0 = torch.where(vmask, hit.mat.emissive, 0.0)
            albedo0 = torch.where(vmask, hit.mat.base_color, 0.0)
            valid0 = hit.valid
            point0, normal0 = hit.point, hit.normal
            # the camera ray itself sees the env map; later misses are the
            # BSDF arm's below
            miss = alive & ~hit.valid
            light = light + torch.where(
                miss[..., None], env.env_radiance(scene.env_image, d), 0.0)
        alive = alive & hit.valid
        v = -d
        tb = disney.build_onb(hit.normal) if aniso else None

        # light-sampling arm: the env map, its shadow walk under any hit
        r1, seed = rng.rand(seed)
        r2, seed = rng.rand(seed)
        l_light = env.sample_env(scene.env_cache, r1, r2)
        front = torch.sum(hit.normal * l_light, dim=-1) > 0.0
        _, sidx = trace(scene.clusters, hit.point, l_light,
                        torch.where(alive & front, INF, 0.0), any_hit=True)
        unblocked = sidx < 0
        radiance_l = env.env_radiance(scene.env_image, l_light)
        pdf_light = env.env_pdf(scene.env_cache, l_light)
        f_r_l, pdf_brdf_l = disney.evaluate_pdf(v, hit.normal, l_light, hit.mat, frame=tb)
        w_l = mis_mix_weight(pdf_light, pdf_brdf_l)
        ndotl_l = torch.clamp_min(torch.sum(hit.normal * l_light, dim=-1), 0.0)
        contrib_l = (w_l[..., None] * history * radiance_l * f_r_l
                     * ndotl_l[..., None]
                     / torch.clamp_min(pdf_light, 1e-12)[..., None])
        use_l = alive & front & unblocked
        light = light + torch.where(use_l[..., None], contrib_l, 0.0)

        # BSDF-sampling arm: its continuation walk
        sob = rng.sobol_vec2(frame + 1, bounce)
        xi1, xi2 = rng.cranley_patterson_rotate(sob, cpr_u, cpr_v)
        xi3, seed = rng.rand(seed)
        l_new = disney.sample(xi1, xi2, xi3, v, hit.normal, hit.mat, frame=tb)
        ndotl = torch.sum(hit.normal * l_new, dim=-1)
        alive = alive & (ndotl > 0.0)
        f_r, pdf_brdf = disney.evaluate_pdf(v, hit.normal, l_new, hit.mat, frame=tb)
        alive = alive & (pdf_brdf > 0.0)
        _, idx2 = trace(scene.clusters, hit.point, l_new, torch.where(alive, INF, 0.0))
        next_missed = idx2 < 0

        env_rad2 = env.env_radiance(scene.env_image, l_new)
        pdf_light2 = env.env_pdf(scene.env_cache, l_new)
        w_b = mis_mix_weight(pdf_brdf, pdf_light2)
        throughput = (f_r * torch.clamp_min(ndotl, 0.0)[..., None]
                      / torch.clamp_min(pdf_brdf, 1e-12)[..., None])
        contrib_miss = w_b[..., None] * history * env_rad2 * throughput
        light = light + torch.where((alive & next_missed)[..., None], contrib_miss, 0.0)

        # an emissive surface hit by the BSDF ray: its material row as the
        # table holds it (no texture read)
        mat2 = scene.tri[torch.clamp_min(idx2, 0), 24].to(torch.int64)
        le = torch.where((alive & ~next_missed)[..., None],
                         fetch_material(mat_rows, mat2).emissive, 0.0)
        light = light + history * le * throughput

        history = history * torch.where(alive[..., None], throughput, 1.0)
        alive = alive & ~next_missed
        orig = hit.point
        d = torch.where(alive[..., None], l_new, d)

    light = clamp_light(light, cfg.clamp_threshold)
    return PathOut(color=light, emission=emission0, albedo=albedo0, valid=valid0,
                   point=point0, normal=normal0)
