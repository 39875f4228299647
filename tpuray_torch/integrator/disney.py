"""Disney ("principled") BRDF: evaluation, pdf and lobe sampling.

Counterpart of tpuray/integrator/disney.py, expression for expression:
Burley 2012 lobes (diffuse + Fd90 retro, subsurface mix, sheen, GTR2
specular with Smith-GGX, GTR1 clearcoat), lobe-probability sampling, the
mixed pdf, and the anisotropic specular path (GTR2_aniso + anisotropic
Smith-GGX) selected per lane when a tangent frame is given.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuray_torch.integrator.intersect import cross

Tensor = torch.Tensor
PI = np.float32(np.pi)
_PI = float(PI)
_TWO_PI = float(np.float32(2.0) * PI)
_INV_PI = float(np.float32(1.0) / PI)


class ShadeMaterial(NamedTuple):
    """Per-hit resolved material (textures already applied)."""

    emissive: Tensor      # (..., 3)
    base_color: Tensor    # (..., 3)
    subsurface: Tensor    # (...)
    metallic: Tensor
    specular: Tensor
    specular_tint: Tensor
    roughness: Tensor
    sheen: Tensor
    sheen_tint: Tensor
    clearcoat: Tensor
    clearcoat_gloss: Tensor
    anisotropic: Tensor | float = 0.0


def safe_normalize(v: Tensor, eps: float = 1e-20) -> Tensor:
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.rsqrt(torch.clamp_min(n2, eps))


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def schlick_fresnel(u: Tensor) -> Tensor:
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    return (m * m) * (m * m) * m


def gtr1(ndoth: Tensor, a) -> Tensor:
    a = torch.as_tensor(a, dtype=torch.float32, device=ndoth.device)
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    val = (a2 - 1.0) / (_PI * torch.log(torch.clamp_min(a2, 1e-8)) * t)
    return torch.where(a >= 1.0, _INV_PI, val)


def gtr2(ndoth: Tensor, a: Tensor) -> Tensor:
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    return a2 / (_PI * t * t)


def smith_g_ggx(ndotv: Tensor, alpha_g) -> Tensor:
    a = alpha_g * alpha_g
    b = ndotv * ndotv
    return 1.0 / (ndotv + torch.sqrt(torch.clamp_min(a + b - a * b, 0.0)))


def gtr2_aniso(ndoth: Tensor, hdotx: Tensor, hdoty: Tensor,
               ax: Tensor, ay: Tensor) -> Tensor:
    t = (hdotx / ax) ** 2 + (hdoty / ay) ** 2 + ndoth * ndoth
    return 1.0 / (_PI * ax * ay * torch.clamp_min(t * t, 1e-12))


def smith_g_ggx_aniso(ndotv: Tensor, vdotx: Tensor, vdoty: Tensor,
                      ax: Tensor, ay: Tensor) -> Tensor:
    t = (vdotx * ax) ** 2 + (vdoty * ay) ** 2 + ndotv * ndotv
    return 1.0 / torch.clamp_min(ndotv + torch.sqrt(torch.clamp_min(t, 0.0)), 1e-8)


def aniso_alphas(mat: ShadeMaterial) -> tuple[Tensor, Tensor]:
    aspect = torch.sqrt(torch.clamp_min(1.0 - mat.anisotropic * 0.9, 1e-6))
    r2 = mat.roughness * mat.roughness
    ax = torch.clamp_min(r2 / aspect, 0.001)
    ay = torch.clamp_min(r2 * aspect, 0.001)
    return ax, ay


def _colors(mat: ShadeMaterial):
    cdlin = mat.base_color
    cdlum = (0.3 * cdlin[..., 0] + 0.6 * cdlin[..., 1] + 0.1 * cdlin[..., 2])
    ctint = torch.where(cdlum[..., None] > 0,
                        cdlin / torch.clamp_min(cdlum[..., None], 1e-12), 1.0)
    cspec = mat.specular[..., None] * (
        (1.0 - mat.specular_tint[..., None]) + mat.specular_tint[..., None] * ctint)
    cspec0 = (0.08 * cspec * (1.0 - mat.metallic[..., None])
              + cdlin * mat.metallic[..., None])
    csheen = (1.0 - mat.sheen_tint[..., None]) + mat.sheen_tint[..., None] * ctint
    return cdlin, cspec0, csheen


def _lobe_probs(mat: ShadeMaterial):
    r_diffuse = 1.0 - mat.metallic
    r_specular = torch.ones_like(mat.metallic)
    r_clearcoat = 0.25 * mat.clearcoat
    r_sum = r_diffuse + r_specular + r_clearcoat
    return r_diffuse / r_sum, r_specular / r_sum, r_clearcoat / r_sum


def _f_terms(ndotl, ndotv, ldoth, ndoth, mat, cdlin, cspec0, csheen, fv,
             ds, gs, dr, gr_v_or_none=None):
    """Shared tail of the evaluators: diffuse/sheen/specular/clearcoat."""
    fd90 = 0.5 + 2.0 * ldoth * ldoth * mat.roughness
    fl = schlick_fresnel(ndotl)
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    fss90 = ldoth * ldoth * mat.roughness
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    denom = torch.clamp_min(ndotl + ndotv, 1e-8)
    ss = 1.25 * (fss * (1.0 / denom - 0.5) + 0.5)
    fh = schlick_fresnel(ldoth)
    fs = cspec0 * (1.0 - fh[..., None]) + fh[..., None]
    fr = 0.04 + 0.96 * fh
    gr = smith_g_ggx(ndotl, 0.25) * (gr_v_or_none if gr_v_or_none is not None
                                     else smith_g_ggx(ndotv, 0.25))
    fsheen = fh[..., None] * mat.sheen[..., None] * csheen
    diffuse_scalar = _INV_PI * (fd + (ss - fd) * mat.subsurface)
    diffuse = diffuse_scalar[..., None] * cdlin + fsheen
    specular = (gs * ds)[..., None] * fs
    clearcoat = (0.25 * gr * fr * dr * mat.clearcoat)[..., None]
    return diffuse * (1.0 - mat.metallic[..., None]) + specular + clearcoat


def _mixed_pdf(ndotl, ldoth, ndoth, ds, dr, p_d, p_s, p_c, valid):
    pdf_diffuse = ndotl / _PI
    safe_ldoth = torch.where(torch.abs(ldoth) < 1e-8, 1e-8, ldoth)
    pdf_specular = ds * ndoth / (4.0 * safe_ldoth)
    pdf_clearcoat = dr * ndoth / (4.0 * safe_ldoth)
    p = p_d * pdf_diffuse + p_s * pdf_specular + p_c * pdf_clearcoat
    return torch.where(valid, torch.clamp_min(p, 1e-10), 0.0)


def evaluate(v: Tensor, n: Tensor, l: Tensor, mat: ShadeMaterial,
             frame: tuple[Tensor, Tensor] | None = None) -> Tensor:
    """f_r(V, L); zero when either direction is under the shading normal.
    frame=(tangent, bitangent) enables the anisotropic path."""
    if frame is not None:
        f, _ = _eval_core(precompute_view(v, n, mat, frame), v, n, l, mat,
                          want_pdf=False)
        return f
    f, _ = evaluate_pdf(v, n, l, mat)
    return f


def evaluate_aniso(v: Tensor, n: Tensor, l: Tensor, x: Tensor, y: Tensor,
                   mat: ShadeMaterial) -> Tensor:
    """Anisotropic f_r(V, L) with tangent frame (x, y) on every lane (the
    standalone oracle of the per-lane path in _eval_core)."""
    ndotl = _dot(n, l)
    ndotv = _dot(n, v)
    valid = (ndotl >= 0) & (ndotv >= 0)
    ndotl = torch.clamp_min(ndotl, 1e-6)
    ndotv = torch.clamp_min(ndotv, 1e-6)
    h = safe_normalize(l + v)
    ndoth = _dot(n, h)
    ldoth = _dot(l, h)
    cdlin, cspec0, csheen = _colors(mat)
    ax, ay = aniso_alphas(mat)
    ds = gtr2_aniso(ndoth, _dot(h, x), _dot(h, y), ax, ay)
    gs = (smith_g_ggx_aniso(ndotl, _dot(l, x), _dot(l, y), ax, ay)
          * smith_g_ggx_aniso(ndotv, _dot(v, x), _dot(v, y), ax, ay))
    dr = gtr1(ndoth, 0.1 + (0.001 - 0.1) * mat.clearcoat_gloss)
    f = _f_terms(ndotl, ndotv, ldoth, ndoth, mat, cdlin, cspec0, csheen,
                 schlick_fresnel(ndotv), ds, gs, dr)
    return torch.where(valid[..., None], f, 0.0)


def pdf(v: Tensor, n: Tensor, l: Tensor, mat: ShadeMaterial,
        frame: tuple[Tensor, Tensor] | None = None) -> Tensor:
    """Mixed sampling pdf of direction l."""
    return evaluate_pdf(v, n, l, mat, frame)[1]


def evaluate_pdf(v: Tensor, n: Tensor, l: Tensor, mat: ShadeMaterial,
                 frame: tuple[Tensor, Tensor] | None = None
                 ) -> tuple[Tensor, Tensor]:
    """(f_r, pdf) of one direction, sharing the common subexpressions."""
    if frame is not None:
        return _eval_core(precompute_view(v, n, mat, frame), v, n, l, mat,
                          want_pdf=True)
    ndotl = _dot(n, l)
    ndotv = _dot(n, v)
    valid = (ndotl >= 0) & (ndotv >= 0)
    ndotl = torch.clamp_min(ndotl, 1e-6)
    ndotv = torch.clamp_min(ndotv, 1e-6)
    h = safe_normalize(l + v)
    ndoth = _dot(n, h)
    ldoth = _dot(l, h)
    cdlin, cspec0, csheen = _colors(mat)
    alpha = torch.clamp_min(mat.roughness * mat.roughness, 0.001)
    ds = gtr2(ndoth, alpha)
    gs = smith_g_ggx(ndotl, mat.roughness) * smith_g_ggx(ndotv, mat.roughness)
    dr = gtr1(ndoth, 0.1 + (0.001 - 0.1) * mat.clearcoat_gloss)
    f = _f_terms(ndotl, ndotv, ldoth, ndoth, mat, cdlin, cspec0, csheen,
                 schlick_fresnel(ndotv), ds, gs, dr)
    f = torch.where(valid[..., None], f, 0.0)
    p_d, p_s, p_c = _lobe_probs(mat)
    return f, _mixed_pdf(ndotl, ldoth, ndoth, ds, dr, p_d, p_s, p_c, valid)


def build_onb(n: Tensor) -> tuple[Tensor, Tensor]:
    """Orthonormal basis around n."""
    # helper: ez where n lies near the x axis, else ex, made on n's device
    # (a constant copied from pageable host memory waits for the stream,
    # and a CUDA graph cannot capture it)
    near_x = torch.abs(n[..., 0:1]) > 0.999
    helper = torch.cat([~near_x, torch.zeros_like(near_x), near_x],
                       dim=-1).to(n.dtype)
    tangent = safe_normalize(cross(n, helper))
    bitangent = safe_normalize(cross(n, tangent))
    return tangent, bitangent


def to_normal_hemisphere(v_local: Tensor, n: Tensor) -> Tensor:
    tangent, bitangent = build_onb(n)
    return (v_local[..., 0:1] * tangent + v_local[..., 1:2] * bitangent
            + v_local[..., 2:3] * n)


def sample_cosine_hemisphere(xi1: Tensor, xi2: Tensor, n: Tensor) -> Tensor:
    r = torch.sqrt(xi1)
    theta = xi2 * 2.0 * _PI
    x = r * torch.cos(theta)
    y = r * torch.sin(theta)
    z = torch.sqrt(torch.clamp_min(1.0 - x * x - y * y, 0.0))
    return to_normal_hemisphere(torch.stack([x, y, z], dim=-1), n)


def records_grad(x: Tensor) -> bool:
    """Whether autograd records ops on x. The helpers below that give an op
    JAX's gradient take their plain form otherwise: same values, fewer
    kernels on the serving path."""
    return torch.is_grad_enabled() and x.requires_grad


_ONE = torch.tensor(1.0)  # a CPU scalar: usable beside tensors on any device


def _cos_from_ratio(r: Tensor) -> Tensor:
    """sqrt(clip(r, 0, 1)) with jnp.clip's gradient at r == 1, where the
    ratio rounds on many lanes: half the gradient, as jnp.minimum splits a
    tie (torch.clamp passes all of it). r == 0 needs xi2 == 1, which the
    samples never reach."""
    if not records_grad(r):
        return torch.sqrt(torch.clamp(r, 0.0, 1.0))
    return torch.sqrt(torch.minimum(torch.clamp_min(r, 0.0), _ONE))


def _sin_from_cos(ct: Tensor) -> Tensor:
    """sqrt(max(1 - ct^2, 0)) with a zero gradient where it is 0. The values
    are the JAX package's, bit for bit; its derivative there is infinite, and
    a lobe that the sample does not pick passes it 0 * inf = NaN, which
    reaches clearcoat_gloss (or roughness) from every lane whose ct rounds
    to 1 (ROADMAP.md section 3)."""
    s = 1.0 - ct * ct
    if not records_grad(s):
        return torch.sqrt(torch.clamp_min(s, 0.0))
    pos = s > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, s, 1.0)), 0.0)


def _reflect(v: Tensor, h: Tensor) -> Tensor:
    return v - 2.0 * torch.sum(v * h, dim=-1, keepdim=True) * h


def sample_gtr2(xi1: Tensor, xi2: Tensor, v: Tensor, n: Tensor,
                alpha: Tensor) -> Tensor:
    phi = _TWO_PI * xi1
    ct = _cos_from_ratio((1.0 - xi2) / (1.0 + (alpha * alpha - 1.0) * xi2))
    st = _sin_from_cos(ct)
    h = to_normal_hemisphere(
        torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1), n)
    return _reflect(-v, h)


def sample_gtr2_aniso(xi1: Tensor, xi2: Tensor, v: Tensor, n: Tensor,
                      ax: Tensor, ay: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """Sample the anisotropic GTR2 half-vector (h ~ D(h)|h.n|) and reflect."""
    phi = _TWO_PI * xi1
    t = torch.sqrt(xi2 / torch.clamp_min(1.0 - xi2, 1e-8))
    h = ((t * ax * torch.cos(phi))[..., None] * x
         + (t * ay * torch.sin(phi))[..., None] * y + n)
    h = safe_normalize(h)
    return _reflect(-v, h)


def sample_gtr1(xi1: Tensor, xi2: Tensor, v: Tensor, n: Tensor,
                alpha: Tensor) -> Tensor:
    phi = _TWO_PI * xi1
    a2 = alpha * alpha
    ct = _cos_from_ratio(
        (1.0 - torch.pow(a2, 1.0 - xi2)) / torch.clamp_min(1.0 - a2, 1e-8))
    st = _sin_from_cos(ct)
    h = to_normal_hemisphere(
        torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1), n)
    return _reflect(-v, h)


def sample(xi1: Tensor, xi2: Tensor, xi3: Tensor, v: Tensor, n: Tensor,
           mat: ShadeMaterial,
           frame: tuple[Tensor, Tensor] | None = None) -> Tensor:
    """Pick a lobe by radiance share (xi3) and sample it (xi1, xi2)."""
    alpha_gtr1 = 0.1 + (0.001 - 0.1) * mat.clearcoat_gloss
    alpha_gtr2 = torch.clamp_min(mat.roughness * mat.roughness, 0.001)
    p_d, p_s, _ = _lobe_probs(mat)

    l_diffuse = sample_cosine_hemisphere(xi1, xi2, n)
    l_specular = sample_gtr2(xi1, xi2, v, n, alpha_gtr2)
    l_clearcoat = sample_gtr1(xi1, xi2, v, n, alpha_gtr1)
    if frame is not None:
        fx, fy = frame
        ax, ay = aniso_alphas(mat)
        l_spec_a = sample_gtr2_aniso(xi1, xi2, v, n, ax, ay, fx, fy)
        l_specular = torch.where((mat.anisotropic > 0.0)[..., None],
                                 l_spec_a, l_specular)

    use_d = (xi3 <= p_d)[..., None]
    use_s = ((xi3 > p_d) & (xi3 <= p_d + p_s))[..., None]
    return torch.where(use_d, l_diffuse, torch.where(use_s, l_specular, l_clearcoat))


class ViewPre(NamedTuple):
    """L-independent terms shared by every BSDF evaluation at one shading
    point (env NEE, point NEE and the sampled bounce)."""

    ndotv: Tensor
    fv: Tensor
    cdlin: Tensor
    cspec0: Tensor
    csheen: Tensor
    alpha: Tensor
    alpha_cc: Tensor
    gs_v: Tensor
    gr_v: Tensor
    p_d: Tensor
    p_s: Tensor
    p_c: Tensor
    fx: Tensor | None = None
    fy: Tensor | None = None
    ax: Tensor | None = None
    ay: Tensor | None = None
    gs_v_aniso: Tensor | None = None


def precompute_view(v: Tensor, n: Tensor, mat: ShadeMaterial,
                    frame: tuple[Tensor, Tensor] | None = None) -> ViewPre:
    """frame=(tangent, bitangent) enables the per-lane anisotropic path for
    lanes with mat.anisotropic > 0; None is the isotropic fast path."""
    ndotv = _dot(n, v)
    ndotv_c = torch.clamp_min(ndotv, 1e-6)
    cdlin, cspec0, csheen = _colors(mat)
    alpha = torch.clamp_min(mat.roughness * mat.roughness, 0.001)
    alpha_cc = 0.1 + (0.001 - 0.1) * mat.clearcoat_gloss
    p_d, p_s, p_c = _lobe_probs(mat)
    pre = ViewPre(
        ndotv=ndotv, fv=schlick_fresnel(ndotv_c), cdlin=cdlin,
        cspec0=cspec0, csheen=csheen, alpha=alpha, alpha_cc=alpha_cc,
        gs_v=smith_g_ggx(ndotv_c, mat.roughness),
        gr_v=smith_g_ggx(ndotv_c, 0.25), p_d=p_d, p_s=p_s, p_c=p_c)
    if frame is not None:
        fx, fy = frame
        ax, ay = aniso_alphas(mat)
        pre = pre._replace(
            fx=fx, fy=fy, ax=ax, ay=ay,
            gs_v_aniso=smith_g_ggx_aniso(ndotv_c, _dot(v, fx), _dot(v, fy),
                                         ax, ay))
    return pre


def _eval_core(pre: ViewPre, v: Tensor, n: Tensor, l: Tensor,
               mat: ShadeMaterial, want_pdf: bool):
    ndotl = _dot(n, l)
    valid = (ndotl >= 0) & (pre.ndotv >= 0)
    ndotl = torch.clamp_min(ndotl, 1e-6)
    ndotv = torch.clamp_min(pre.ndotv, 1e-6)

    h = safe_normalize(l + v)
    ndoth = _dot(n, h)
    ldoth = _dot(l, h)

    ds = gtr2(ndoth, pre.alpha)
    gs = smith_g_ggx(ndotl, mat.roughness) * pre.gs_v
    if pre.fx is not None:
        # per-lane anisotropic specular; anisotropic == 0 lanes keep the
        # isotropic math exactly
        am = mat.anisotropic > 0.0
        ds_a = gtr2_aniso(ndoth, _dot(h, pre.fx), _dot(h, pre.fy),
                          pre.ax, pre.ay)
        gs_a = smith_g_ggx_aniso(ndotl, _dot(l, pre.fx), _dot(l, pre.fy),
                                 pre.ax, pre.ay) * pre.gs_v_aniso
        ds = torch.where(am, ds_a, ds)
        gs = torch.where(am, gs_a, gs)

    dr = gtr1(ndoth, pre.alpha_cc)
    f = _f_terms(ndotl, ndotv, ldoth, ndoth, mat, pre.cdlin, pre.cspec0,
                 pre.csheen, pre.fv, ds, gs, dr, pre.gr_v)
    f = torch.where(valid[..., None], f, 0.0)
    if not want_pdf:
        return f, None
    return f, _mixed_pdf(ndotl, ldoth, ndoth, ds, dr, pre.p_d, pre.p_s,
                         pre.p_c, valid)


def evaluate_pre(pre: ViewPre, v: Tensor, n: Tensor, l: Tensor,
                 mat: ShadeMaterial) -> Tensor:
    """evaluate() with the view-dependent terms shared (same math)."""
    return _eval_core(pre, v, n, l, mat, want_pdf=False)[0]


def evaluate_pdf_pre(pre: ViewPre, v: Tensor, n: Tensor, l: Tensor,
                     mat: ShadeMaterial) -> tuple[Tensor, Tensor]:
    """evaluate_pdf() with the view-dependent terms shared."""
    return _eval_core(pre, v, n, l, mat, want_pdf=True)
