"""Multiple-importance-sampling integrator (RenderConfig.integrator="mis").

Counterpart of tpuray/integrator/mis.py: per bounce, an env-map light
sample and a BSDF sample combined with the squared balance heuristic;
point lights are not part of it. Every walk goes through
path_tracer.trace, one for one with the JAX package's calls: the bounce-0
primaries (K1 with a shared origin; K6 on a forest), then per bounce the
light-shadow walk and the BSDF-continuation walk, and from bounce 1 on the
bounce's own trace (K3 on a single tree). That bounce trace repeats the
previous bounce's continuation ray (ROADMAP.md logs the repeat as later
work).
"""
from __future__ import annotations

import torch

from tpuray_torch.integrator import disney
from tpuray_torch.integrator import path_tracer as pt
from tpuray_torch.integrator.gather_tables import fetch_material, fetch_tri
from tpuray_torch.sampling import envmap as env
from tpuray_torch.sampling import rng

Tensor = torch.Tensor

# tile_coherent_sampling draws one stream per block of this many lanes: the
# JAX package's packet size (tpuray/kernels/trace_pallas.py:PACKET, 32x128)
PACKET = 4096


def mis_mix_weight(a: Tensor, b: Tensor) -> Tensor:
    """Squared balance heuristic a^2 / (a^2 + b^2)."""
    t = a * a
    return t / torch.clamp_min(b * b + t, 1e-20)


def trace_paths_mis(pk, tables, tracer, orig: Tensor, d: Tensor, px: Tensor,
                    py: Tensor, frame: int, cfg, common_origin: bool,
                    aniso: bool) -> "pt.PTOutput":
    """path_tracer.trace_paths for integrator="mis" (its packed tables and
    tracer given). orig (N, 3), d (N, 3), px/py (N,) the RNG keys."""
    n = d.shape[0]
    dev = d.device
    seed = rng.pixel_seed(px, py, frame)
    _, seed = rng.rand(seed)
    _, seed = rng.rand(seed)

    coherent = cfg.tile_coherent_sampling and n % PACKET == 0
    if coherent:
        # one stream per PACKET lanes, keyed on the block's index
        tid = torch.arange(n // PACKET, dtype=torch.int64, device=dev)
        tseed = rng.pixel_seed(tid, (tid * 7919) & rng.M32, frame)

        def tile_rand(ts):
            u, ts = rng.rand(ts)
            return torch.repeat_interleave(u, PACKET), ts

        cpr_u, cpr_v = rng.cranley_patterson_offsets(tid, (tid * 31) & rng.M32)
        cpr_u = torch.repeat_interleave(cpr_u, PACKET)
        cpr_v = torch.repeat_interleave(cpr_v, PACKET)
    else:
        cpr_u, cpr_v = rng.cranley_patterson_offsets(px, py)

    def z3():
        return torch.zeros((n, 3), dtype=torch.float32, device=dev)

    light = z3()
    history = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    emission0, albedo0, point0, normal0 = z3(), z3(), z3(), z3()
    t0 = torch.full((n,), pt.INF, dtype=torch.float32, device=dev)
    valid0 = torch.zeros(n, dtype=torch.bool, device=dev)

    for bounce in range(cfg.max_tracing_depth):
        # terminated paths get t_max = 0 and cost no walk
        b_tmax = pt.INF if bounce == 0 else torch.where(alive, pt.INF, 0.0)
        t, idx = pt.trace(tracer, tables, orig, d, b_tmax,
                          common_origin=common_origin and bounce == 0)
        hit = pt.resolve_hit(pk, orig, d, t, idx, cfg)

        if bounce == 0:
            vmask = hit.valid[..., None]
            emission0 = torch.where(vmask, hit.mat.emissive, 0.0)
            albedo0 = torch.where(vmask, hit.mat.base_color, 0.0)
            t0, valid0 = t, hit.valid
            point0, normal0 = hit.point, hit.normal
            # the camera ray itself sees the env map; later misses are the
            # BSDF arm's below
            miss = alive & ~hit.valid
            light = light + torch.where(
                miss[..., None], env.env_radiance(pk.env_image, d), 0.0)
        alive = alive & hit.valid
        v = -d
        tb = disney.build_onb(hit.normal) if aniso else None

        # light-sampling arm
        if coherent:
            r1, tseed = tile_rand(tseed)
            r2, tseed = tile_rand(tseed)
        else:
            r1, seed = rng.rand(seed)
            r2, seed = rng.rand(seed)
        l_light = env.sample_env(pk.env_cache, r1, r2)
        front = torch.sum(hit.normal * l_light, dim=-1) > 0.0
        _, sidx = pt.trace(tracer, tables, hit.point, l_light,
                           torch.where(alive & front, pt.INF, 0.0),
                           any_hit=True)
        unblocked = sidx < 0
        radiance_l = env.env_radiance(pk.env_image, l_light)
        pdf_light = env.env_pdf(pk.env_cache, l_light)
        f_r_l, pdf_brdf_l = disney.evaluate_pdf(v, hit.normal, l_light,
                                                hit.mat, frame=tb)
        w_l = mis_mix_weight(pdf_light, pdf_brdf_l)
        ndotl_l = torch.clamp_min(torch.sum(hit.normal * l_light, dim=-1), 0.0)
        contrib_l = (w_l[..., None] * history * radiance_l * f_r_l
                     * ndotl_l[..., None]
                     / torch.clamp_min(pdf_light, 1e-12)[..., None])
        use_l = alive & front & unblocked
        light = light + torch.where(use_l[..., None], contrib_l, 0.0)

        # BSDF-sampling arm
        sob = rng.sobol_vec2(frame + 1, bounce)
        xi1, xi2 = rng.cranley_patterson_rotate(sob, cpr_u, cpr_v)
        if coherent:
            xi3, tseed = tile_rand(tseed)
        else:
            xi3, seed = rng.rand(seed)
        l_new = disney.sample(xi1, xi2, xi3, v, hit.normal, hit.mat, frame=tb)
        ndotl = torch.sum(hit.normal * l_new, dim=-1)
        alive = alive & (ndotl > 0.0)

        f_r, pdf_brdf = disney.evaluate_pdf(v, hit.normal, l_new, hit.mat,
                                            frame=tb)
        alive = alive & (pdf_brdf > 0.0)

        _, idx2 = pt.trace(tracer, tables, hit.point, l_new,
                           torch.where(alive, pt.INF, 0.0))
        next_missed = idx2 < 0

        env_rad2 = env.env_radiance(pk.env_image, l_new)
        pdf_light2 = env.env_pdf(pk.env_cache, l_new)
        w_b = mis_mix_weight(pdf_brdf, pdf_light2)
        throughput = (f_r * torch.clamp_min(ndotl, 0.0)[..., None]
                      / torch.clamp_min(pdf_brdf, 1e-12)[..., None])
        contrib_miss = w_b[..., None] * history * env_rad2 * throughput
        light = light + torch.where((alive & next_missed)[..., None],
                                    contrib_miss, 0.0)

        # an emissive surface hit by the BSDF ray
        hit2_mat = fetch_material(
            pk.mat_table, fetch_tri(pk.tri_table, torch.clamp_min(idx2, 0)).mat_id)
        le = torch.where((alive & ~next_missed)[..., None], hit2_mat.emissive, 0.0)
        light = light + history * le * throughput

        history = history * torch.where(alive[..., None], throughput, 1.0)
        alive = alive & ~next_missed
        orig = hit.point
        d = torch.where(alive[..., None], l_new, d)

    light = torch.clamp(light, 0.0, cfg.clamp_threshold)
    light = torch.where(torch.isnan(light), 0.0, light)
    return pt.PTOutput(color=light, emission=emission0, albedo=albedo0,
                       first_hit_t=t0, first_hit_valid=valid0,
                       first_hit_point=point0, first_hit_normal=normal0)
