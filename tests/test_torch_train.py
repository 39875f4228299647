"""The differentiable path (train/optimize.py, the topology-only traversal,
resolve_hit's detached t) against tpuray on the CPU.

The same numpy-built scene, camera and target go through tpuray's
train.optimize (jax.value_and_grad of render_flat's MSE) and the port's
(torch autograd), at 32x32, depth 2, without compaction. The target is the
scene's own render; the base colour is perturbed as cli/main.py:cmd_train
does, so every residual has the training run's scale.

The JAX reference runs with one change, made here in-process (no file of
tpuray changes): its Disney samplers' sin-from-cos,
jnp.sqrt(jnp.maximum(0, 1 - ct^2)), has an infinite derivative where ct
rounds to 1, and the lobe that the sample does not pick passes it on as
0 * inf = NaN. clearcoat_gloss = 1 (the scenes' default) rounds ct to 1 on
every lane whose xi2 is below ~0.004, so tpuray's gradient of
clearcoat_gloss is NaN, and after one Adam step the whole table is
(ROADMAP.md section 3). The port computes the same values with a zero
gradient there (disney._sin_from_cos); the reference is patched to that,
and test_reference_sampler_gradient_is_nan shows the difference on the
sampler alone.

Tolerances:
- loss within rtol 1e-4;
- every MaterialTable and PointLights field: |grad - ref| <= 5e-3 of the
  field's largest |ref| (the two agree to ~1e-4 of it; XLA on the CPU
  contracts multiply-adds into FMAs, which moves hit points by an ulp, and
  a glossy lobe's f/pdf turns that into a visible change on ~0.5% of rays,
  tests/test_torch_frame.py). A field the loss does not reach has a zero
  gradient in JAX and none in torch (the MIS integrator and point lights);
- one Adam step: the params within atol 1e-6 of optax.adam(1e-2)'s step on
  the JAX gradients (the first step moves each parameter by about
  lr * sign(grad));
- ray_directions within atol 1e-6 (XLA's einsum may contract).
"""
import dataclasses

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

import tpuray.scene.partition as jpart
from tpuray.accel.bvh import build_bvh
from tpuray.integrator import disney as jdisney
from tpuray.scene.camera import OrbitCamera as JOrbitCamera
from tpuray.scene.config import RenderConfig as JRenderConfig
from tpuray.scene.procedural import make_large_scene, make_test_scene
from tpuray.train import optimize as jopt

import tpuray_torch
from tpuray_torch.dist.sharding import make_mesh
from tpuray_torch.integrator import disney, gather_tables, path_tracer
from tpuray_torch.integrator.gather_tables import pack_scene_tables
from tpuray_torch.kernels import atrous as ka
from tpuray_torch.kernels import reproject as kr
from tpuray_torch.kernels import trace as kt
from tpuray_torch.kernels import trace_chunked as ktc
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.render.renderer import render_frame
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.types import scene_from_numpy, scene_to_numpy
from tpuray_torch.train import optimize

torch.set_num_threads(2)

H = W = 32
FRAME = 3
BASE = dict(width=W, height=H, max_tracing_depth=2, compact_frac=0.0,
            compact_auto=False)
LARGE = dict(n_spheres=6, subdiv=2, max_chunk_tris=512, env_width=32)
CASES = {  # RenderConfig fields and camera of each path
    "fused": (dict(), dict(yaw_deg=20.0)),
    "separate_walk": (dict(fused_secondary=False), dict(yaw_deg=20.0)),
    "mis": (dict(integrator="mis"), dict(yaw_deg=20.0)),
    "forest": (dict(), dict(yaw_deg=20.0, radius=4.0)),
}


def _sin_from_cos(ct):
    s = 1.0 - ct * ct
    pos = s > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, s, 1.0)), 0.0)


def _guarded_gtr2(xi1, xi2, v, n, alpha):
    """tpuray.integrator.disney.sample_gtr2 with the port's sin-from-cos."""
    phi = 2.0 * jdisney.PI * xi1
    ct = jnp.sqrt(jnp.clip((1.0 - xi2) / (1.0 + (alpha * alpha - 1.0) * xi2), 0.0, 1.0))
    st = _sin_from_cos(ct)
    h = jdisney.to_normal_hemisphere(
        jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1), n)
    return jdisney._reflect(-v, h)


def _guarded_gtr1(xi1, xi2, v, n, alpha):
    """tpuray.integrator.disney.sample_gtr1 with the port's sin-from-cos."""
    phi = 2.0 * jdisney.PI * xi1
    a2 = alpha * alpha
    ct = jnp.sqrt(jnp.clip((1.0 - jnp.power(a2, 1.0 - xi2))
                           / jnp.maximum(1.0 - a2, 1e-8), 0.0, 1.0))
    st = _sin_from_cos(ct)
    h = jdisney.to_normal_hemisphere(
        jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1), n)
    return jdisney._reflect(-v, h)


@pytest.fixture(scope="module")
def scenes():
    js = make_test_scene(subdiv=2, env_width=32)
    orig = jpart.build_bvh
    jpart.build_bvh = lambda tv, leaf=8, force_py=False: build_bvh(
        tv, leaf, force_py=True)
    try:
        jl = make_large_scene(**LARGE)
    finally:
        jpart.build_bvh = orig
    return {"single": (js, scene_from_numpy(scene_to_numpy(js))),
            "forest": (jl, scene_from_numpy(scene_to_numpy(jl)))}


def _perturb_jax(params):
    return {k: (v.replace(base_color=v.base_color * 0.4 + 0.3)
                if k == "materials" else v) for k, v in params.items()}


def _perturb_port(params):
    with torch.no_grad():
        params["materials"].base_color.mul_(0.4).add_(0.3)


@pytest.fixture(scope="module")
def jax_refs(scenes):
    """(target, loss, grads, perturbed params) of tpuray per path, one
    jax.value_and_grad each; fused and separate walks are one program on
    the CPU (tpuray fuses only on a TPU), so they share it."""
    refs = {}
    orig = jdisney.sample_gtr1, jdisney.sample_gtr2
    jdisney.sample_gtr1, jdisney.sample_gtr2 = _guarded_gtr1, _guarded_gtr2
    try:
        for case in ("fused", "mis", "forest"):
            extra, cam_kw = CASES[case]
            js = scenes["forest" if case == "forest" else "single"][0]
            cfg = JRenderConfig(**BASE, **extra)
            cam = JOrbitCamera(width=W, height=H, **cam_kw).snapshot()
            target = np.asarray(jopt.render_flat(js, cam, cfg, H, W, FRAME))
            params, rebuild = jopt.split_trainable(js)
            params = _perturb_jax(params)

            def loss_fn(p):
                img = jopt.render_flat(rebuild(p), cam, cfg, H, W, FRAME)
                return jnp.mean((img - target) ** 2)

            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
            refs[case] = (target, float(loss), grads, params)
    finally:
        jdisney.sample_gtr1, jdisney.sample_gtr2 = orig
    refs["separate_walk"] = refs["fused"]
    return refs


def _port_loss(scenes, case, target):
    extra, cam_kw = CASES[case]
    ts = scenes["forest" if case == "forest" else "single"][1]
    params, rebuild = optimize.split_trainable(ts, device="cpu")
    _perturb_port(params)
    cam = OrbitCamera(width=W, height=H, **cam_kw).snapshot()
    img = optimize.render_flat(rebuild(params), cam, RenderConfig(**BASE, **extra),
                               H, W, FRAME)
    return params, torch.mean((img - torch.tensor(target)) ** 2)


def _fields(params):
    for group, table in params.items():
        for f in dataclasses.fields(table):
            yield f"{group}.{f.name}", getattr(table, f.name)


def test_ray_directions_match():
    jcam = JOrbitCamera(width=48, height=32, yaw_deg=33.0, pitch_deg=-12.0).snapshot()
    cam = OrbitCamera(width=48, height=32, yaw_deg=33.0, pitch_deg=-12.0).snapshot()
    got = cam.ray_directions(32, 48)
    assert got.shape == (32, 48, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jcam.ray_directions(32, 48)),
                               atol=1e-6)
    # row 0 is the top image row
    assert float((got[0, 0] - got[-1, 0]) @ cam.cam_to_world[:, 1]) > 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match(scenes, jax_refs, case):
    target, ref_loss, ref_grads, _ = jax_refs[case]
    params, loss = _port_loss(scenes, case, target)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-4)
    ref = dict(_fields(ref_grads))
    reached = 0
    for name, leaf in _fields(params):
        want = np.asarray(ref[name])
        got = np.zeros_like(want) if leaf.grad is None else leaf.grad.numpy()
        scale = float(np.abs(want).max())
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-3 * scale + 1e-12,
                                   err_msg=name)
        reached += scale > 0.0
    # colour, BSDF and (but for MIS) light fields all carry a gradient
    assert reached >= (7 if case == "mis" else 9)
    assert np.abs(np.asarray(ref_grads["materials"].base_color)).max() > 1e-3


def test_reference_sampler_gradient_is_nan():
    """tpuray's sample_gtr1 differentiates sqrt(max(0, 1 - ct^2)) at ct = 1
    into NaN; the port's sampler returns the same directions with a finite
    gradient (the reason for the patched reference above)."""
    rng = np.random.default_rng(7)
    n = 256
    xi1 = rng.random(n).astype(np.float32)
    xi2 = rng.random(n).astype(np.float32) * 0.01  # ct rounds to 1 on many
    nrm = np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (n, 1))
    v = rng.standard_normal((n, 3)).astype(np.float32)
    v[:, 1] = np.abs(v[:, 1]) + 0.5
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    alpha = np.float32(0.001)  # clearcoat_gloss = 1

    def jloss(a, fn):
        return jnp.sum(fn(xi1, xi2, v, nrm, a) * 0.0)  # a lobe nobody picks

    assert np.isnan(float(jax.grad(jloss)(alpha, jdisney.sample_gtr1)))
    assert float(jax.grad(jloss)(alpha, _guarded_gtr1)) == 0.0
    a = torch.tensor(alpha, requires_grad=True)
    args = [torch.from_numpy(x) for x in (xi1, xi2, v, nrm)]
    out = disney.sample_gtr1(*args, a)
    (out * 0.0).sum().backward()
    assert float(a.grad) == 0.0
    want = np.asarray(jdisney.sample_gtr1(xi1, xi2, v, nrm, alpha))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lobe", ["gtr1", "gtr2"])
def test_sampler_gradients_match(lobe):
    """Per lane, d(sampled direction)/d(alpha) against the (guarded)
    reference, on lanes whose clip(ratio, 0, 1) ties at 1: jnp.clip passes
    half the gradient there, torch.clamp all of it; the port splits it as
    JAX does. rtol 1e-4 / atol 1e-7 (trig rounds differently under XLA)."""
    rng = np.random.default_rng(8)
    n = 4096
    xi1 = rng.random(n).astype(np.float32)
    xi2 = (rng.random(n) * 0.01).astype(np.float32)
    nrm = np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (n, 1))
    v = rng.standard_normal((n, 3)).astype(np.float32)
    v[:, 1] = np.abs(v[:, 1]) + 0.5
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    w = rng.standard_normal((n, 3)).astype(np.float32)
    alpha = np.full(n, 0.001 if lobe == "gtr1" else 0.01, np.float32)
    ref_fn = _guarded_gtr1 if lobe == "gtr1" else _guarded_gtr2
    want = np.asarray(jax.grad(
        lambda a: jnp.sum(ref_fn(xi1, xi2, v, nrm, a) * w))(alpha))
    a = torch.tensor(alpha, requires_grad=True)
    fn = disney.sample_gtr1 if lobe == "gtr1" else disney.sample_gtr2
    (fn(*[torch.from_numpy(x) for x in (xi1, xi2, v, nrm)], a)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), want, rtol=1e-4, atol=1e-7)
    # the tie is common here: clip(ratio, 0, 1) returns exactly 1
    r = (1.0 - xi2) / (1.0 + (alpha * alpha - 1.0) * xi2) if lobe == "gtr2" else (
        (1.0 - np.power(alpha * alpha, 1.0 - xi2)) / (1.0 - alpha * alpha))
    assert (r.astype(np.float32) >= 1.0).sum() >= 10


def test_train_step_matches_optax(scenes, jax_refs):
    """One make_train_step step (default Adam) against optax.adam(1e-2)
    applied to tpuray's gradients, as tpuray's make_train_step does."""
    target, ref_loss, ref_grads, ref_params = jax_refs["fused"]
    opt = optax.adam(1e-2)
    updates, _ = opt.update(ref_grads, opt.init(ref_params), ref_params)
    want = dict(_fields(optax.apply_updates(ref_params, updates)))
    ts = scenes["single"][1]
    params, rebuild = optimize.split_trainable(ts, device="cpu")
    _perturb_port(params)
    init, step = optimize.make_train_step(rebuild, RenderConfig(**BASE), H, W)
    state = init(params)
    cam = OrbitCamera(width=W, height=H, **CASES["fused"][1]).snapshot()
    state, loss = step(state, torch.tensor(target), cam, FRAME)
    assert not loss.requires_grad
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-4)
    moved = 0
    for name, leaf in _fields(state.params):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(want[name]),
                                   rtol=0, atol=1e-6, err_msg=name)
        moved += int((leaf.grad != 0).sum())
    assert moved >= 20
    # the leaves were updated in place: the next loss is the new params'
    state, loss2 = step(state, torch.tensor(target), cam, FRAME)
    assert loss2.item() < loss.item()


def test_fetch_rows_one_hot_backward():
    """A small table's row fetch sums its gradient with a one-hot matmul:
    the same as index_add_ of the row gradients, and plain indexing when
    nothing records a graph."""
    rng = np.random.default_rng(5)
    table = torch.tensor(rng.random((3, 18), dtype=np.float32), requires_grad=True)
    idx = torch.from_numpy(rng.integers(0, 3, 5000))
    w = torch.from_numpy(rng.standard_normal((5000, 18)).astype(np.float32))
    (gather_tables.fetch_rows(table, idx) * w).sum().backward()
    want = torch.zeros(3, 18, dtype=torch.float64).index_add_(0, idx, w.double())
    # float32 sums of ~1,700 terms of |w| ~ 1: a few ulps of their sum of |w|
    torch.testing.assert_close(table.grad.double(), want, rtol=0, atol=2e-4)
    with torch.no_grad():
        assert torch.equal(gather_tables.fetch_rows(table, idx), table[idx])


def test_trace_outputs_never_require_grad(scenes):
    """The topology-only contract: every traversal entry, kernel wrapper or
    plain version, returns (t, idx) without a graph."""
    _, ts = scenes["single"]
    _, tf = scenes["forest"]
    tables = path_tracer.pack_traversal(ts)
    forest = path_tracer.pack_traversal(tf)
    rng = np.random.default_rng(3)
    n = 256
    o = torch.tensor([[0.0, 0.3, 2.0]]).expand(n, 3).clone().requires_grad_(True)
    d = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(d, dim=-1).requires_grad_(True)
    tm = torch.full((n,), 1e30, requires_grad=True)
    outs = [kt.trace_packets(tables, o, d, tm, False, True),
            kt.trace_packets_plain(tables, o, d, tm),
            kt.trace_batched(tables, o, d, tm, True),
            ktc.trace_chunked(forest, o, d, tm),
            ktc.trace_chunked_plain(forest, o, d, tm, True),
            *kt.trace_multi(tables, o, [d, d], [tm, tm], [False, True]),
            *kt.trace_multi_plain(tables, o, [d], [tm], [False])]
    for t, idx in outs:
        assert not t.requires_grad and not idx.requires_grad
        assert t.grad_fn is None
    t, idx = outs[0]
    assert bool((idx >= 0).any())
    # resolve_hit detaches t: d(point)/d(d) is t itself, with no term
    # through t's dependence on d
    hit = path_tracer.resolve_hit(pack_scene_tables(ts), o, d, t, idx,
                                  RenderConfig(**BASE))
    g_d, = torch.autograd.grad(hit.point.sum(), d)
    t_used = torch.where(idx >= 0, t, 1.0)
    torch.testing.assert_close(g_d, t_used[:, None].expand(n, 3), rtol=0, atol=0)


def test_renderer_step_builds_no_graph(scenes):
    _, ts = scenes["single"]
    params, rebuild = optimize.split_trainable(ts, device="cpu")
    cfg = RenderConfig(width=16, height=16, compact_frac=0.0, compact_auto=False)
    r = tpuray_torch.Renderer(rebuild(params), cfg, device="cpu")
    out = r.step(OrbitCamera(width=16, height=16).snapshot())
    for x in (out.pt_color, out.final, out.svgf.taa, r.state.accum_color):
        assert not x.requires_grad and x.grad_fn is None
    # render_frame itself differentiates (SVGF off)
    _, fo = render_frame(rebuild(params), OrbitCamera(width=16, height=16).snapshot(),
                         FrameState.initial(16, 16),
                         dataclasses.replace(cfg, enable_svgf=False), 16, 16)
    fo.pt_color.mean().backward()
    assert float(params["materials"].base_color.grad.abs().max()) > 0.0


def test_denoise_kernels_raise_under_grad(scenes):
    """K4 and K5 are forward-only (as tpuray's Pallas kernels: no JVP rule);
    pallas_denoise=False takes the plain stages, which differentiate. (With
    TAA on, the gradient is NaN in both packages: taa.py's neighbourhood
    sigma, sqrt(|m2/9 - mu^2|), is 0 on flat regions; ROADMAP.md section 3.)"""
    _, ts = scenes["single"]
    params, rebuild = optimize.split_trainable(ts, device="cpu")
    cam = OrbitCamera(width=16, height=16).snapshot()
    cfg = RenderConfig(width=16, height=16, compact_frac=0.0, compact_auto=False)
    with pytest.raises(RuntimeError, match="pallas_denoise=False"):
        render_frame(rebuild(params), cam, FrameState.initial(16, 16), cfg, 16, 16)
    x = torch.rand((8, 8, 3), requires_grad=True)
    z = torch.rand((8, 8))
    with pytest.raises(RuntimeError, match="K5.*pallas_denoise=False"):
        ka.atrous_chain(x, z, x.detach(), z, z, cfg)
    k4_in = {name: torch.rand((8, 8, c) if c > 1 else (8, 8))
             for name, c in kr._INPUTS}
    k4_in["color"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="K4.*no JVP rule"):
        kr.reproject_variance_fused(cfg, **k4_in)
    with torch.no_grad():  # nothing to lose: the wrapper runs
        kr.reproject_variance_fused(cfg, **k4_in)
    _, out = render_frame(rebuild(params), cam, FrameState.initial(16, 16),
                          dataclasses.replace(cfg, pallas_denoise=False,
                                              enable_taa=False), 16, 16)
    out.final.mean().backward()
    g = params["materials"].base_color.grad
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0.0


def test_split_trainable(scenes, monkeypatch):
    _, ts = scenes["single"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        optimize.split_trainable(ts)
    params, rebuild = optimize.split_trainable(ts, train_lights=False, device="cpu")
    assert set(params) == {"materials"}
    leaves = optimize.parameters(params)
    assert len(leaves) == 14
    assert all(x.is_leaf and x.requires_grad for x in leaves)
    s = rebuild(params)
    assert s.materials is params["materials"] and s.lights is not None
    assert not ts.materials.base_color.requires_grad  # the input is untouched
    # the row-parallel step is ported (tests/test_torch_dist.py); it needs a
    # mesh whose world size divides the height
    init, step = optimize.make_sharded_train_step(rebuild, RenderConfig(**BASE), H, W,
                                                  make_mesh("cpu"))
    assert callable(init) and callable(step)
    with pytest.raises(ValueError, match="multiple"):
        optimize.make_sharded_train_step(rebuild, RenderConfig(**BASE), H + 1, W,
                                         dataclasses.replace(make_mesh("cpu"), size=2))
