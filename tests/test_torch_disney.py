"""tpuray_torch.integrator.disney vs tpuray.integrator.disney on the CPU:
lobe sampling and (f_r, pdf), isotropic and anisotropic, on random
materials and directions made with numpy.

Tolerance: rtol 1e-5, atol 1e-6 on all but 0.2% of the values, and every
value within rtol 1e-3, atol 1e-5. The expressions are the same, but XLA's
CPU rsqrt and PyTorch's differ by one ulp on about a third of inputs, and
sqrt, pow, log and trig on a few percent. Ill-conditioned steps (the GTR2
peak at low roughness, sqrt(1 - cos^2) near the pole of a lobe sample)
grow those ulps past 1e-5 on a few lanes in a thousand."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuray.integrator import disney as jd

from tpuray_torch.integrator import disney

torch.set_num_threads(2)

N = 4096
ROUGHNESS = {"rough": (0.2, 1.0), "glossy": (0.02, 0.2)}


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _make_inputs(lo, hi):
    r = np.random.default_rng(11)
    f = lambda *s: r.random(s).astype(np.float32)
    n = _unit(r.standard_normal((N, 3)).astype(np.float32))
    v = _unit(n * 0.7 + r.standard_normal((N, 3)).astype(np.float32) * 0.6)
    l = _unit(r.standard_normal((N, 3)).astype(np.float32))
    mat = dict(
        emissive=f(N, 3) * 0.2, base_color=f(N, 3), subsurface=f(N),
        metallic=f(N), specular=f(N), specular_tint=f(N),
        roughness=lo + (hi - lo) * f(N), sheen=f(N), sheen_tint=f(N),
        clearcoat=f(N), clearcoat_gloss=f(N),
        anisotropic=np.where(f(N) > 0.5, f(N), 0.0).astype(np.float32))
    xi = [f(N) for _ in range(3)]
    return dict(n=n, v=v, l=l, mat=mat, xi=xi)


@pytest.fixture(scope="module", params=sorted(ROUGHNESS))
def inputs(request):
    return _make_inputs(*ROUGHNESS[request.param])


def _both(inputs):
    t = {k: torch.from_numpy(inputs[k]) for k in ("n", "v", "l")}
    j = {k: jnp.asarray(inputs[k]) for k in ("n", "v", "l")}
    tm = disney.ShadeMaterial(**{k: torch.from_numpy(a) for k, a in inputs["mat"].items()})
    jm = jd.ShadeMaterial(**{k: jnp.asarray(a) for k, a in inputs["mat"].items()})
    return t, j, tm, jm


def _close(got, want):
    g, w = got.numpy(), np.asarray(want)
    off = ~np.isclose(g, w, rtol=1e-5, atol=1e-6)
    assert off.mean() <= 2e-3, f"{off.mean():.3%} of values beyond rtol 1e-5"
    np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("aniso", [False, True])
def test_sample_matches(inputs, aniso):
    t, j, tm, jm = _both(inputs)
    tb = disney.build_onb(t["n"]) if aniso else None
    jb = jd.build_onb(j["n"]) if aniso else None
    if aniso:
        for a, b in zip(tb, jb):
            _close(a, b)
    xi = [torch.from_numpy(x) for x in inputs["xi"]]
    jxi = [jnp.asarray(x) for x in inputs["xi"]]
    got = disney.sample(*xi, t["v"], t["n"], tm, frame=tb)
    want = jd.sample(*jxi, j["v"], j["n"], jm, frame=jb)
    _close(got, want)


@pytest.mark.parametrize("aniso", [False, True])
def test_evaluate_pdf_pre_matches(inputs, aniso):
    t, j, tm, jm = _both(inputs)
    tb = disney.build_onb(t["n"]) if aniso else None
    jb = jd.build_onb(j["n"]) if aniso else None
    pre = disney.precompute_view(t["v"], t["n"], tm, frame=tb)
    jpre = jd.precompute_view(j["v"], j["n"], jm, frame=jb)
    f, p = disney.evaluate_pdf_pre(pre, t["v"], t["n"], t["l"], tm)
    jf, jp = jd.evaluate_pdf_pre(jpre, j["v"], j["n"], j["l"], jm)
    assert (np.asarray(jp) > 0).mean() > 0.2  # enough valid lanes
    _close(f, jf)
    _close(p, jp)
    _close(disney.evaluate_pre(pre, t["v"], t["n"], t["l"], tm),
           jd.evaluate_pre(jpre, j["v"], j["n"], j["l"], jm))


def test_unshared_forms_match(inputs):
    t, j, tm, jm = _both(inputs)
    _close(disney.evaluate(t["v"], t["n"], t["l"], tm),
           jd.evaluate(j["v"], j["n"], j["l"], jm))
    _close(disney.pdf(t["v"], t["n"], t["l"], tm),
           jd.pdf(j["v"], j["n"], j["l"], jm))
    tb, jb = disney.build_onb(t["n"]), jd.build_onb(j["n"])
    _close(disney.evaluate_aniso(t["v"], t["n"], t["l"], *tb, tm),
           jd.evaluate_aniso(j["v"], j["n"], j["l"], *jb, jm))
    f, p = disney.evaluate_pdf(t["v"], t["n"], t["l"], tm, frame=tb)
    jf, jp = jd.evaluate_pdf(j["v"], j["n"], j["l"], jm, frame=jb)
    _close(f, jf)
    _close(p, jp)

