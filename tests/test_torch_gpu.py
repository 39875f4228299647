"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips without a CUDA device. This file
imports no jax (the card's machine has none), so it runs there without
tests/conftest.py:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances: closest-hit idx and t exact (the kernels repeat the plain
version's float ops with FMA contraction off; a differing idx is allowed
only as an exact-t tie, which the walk order decides); any-hit hit/miss
exact. K4 and K5 (the denoiser) repeat their plain versions' op order too:
history_len exact, every other output within rtol 1e-5 / atol 1e-6 (exp
and pow may round their last bit differently); frames through the kernels
within tests/test_dist_frame.py's image tolerance of the plain frame."""
import numpy as np
import pytest
import torch

from tpuray_torch.kernels import atrous as ka
from tpuray_torch.kernels import reproject as kr
from tpuray_torch.kernels import trace as kt
from tpuray_torch.render.renderer import Renderer
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.procedural import make_test_scene

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    scene = make_test_scene(subdiv=4, env_width=64, device="cuda")
    return scene, kt.pack_scene(scene.bvh, scene.triangles)


def _rays(seed, n, common_origin=False):
    rng = np.random.default_rng(seed)
    o = np.tile(np.asarray([[0.0, 0.3, 2.0]], np.float32), (n, 1))
    if not common_origin:
        o += (rng.random((n, 3)).astype(np.float32) - 0.5) * 1.5
        o[: n // 8] = 0.0  # inside the sphere's boxes: negative slab t0
    tgt = (rng.random((n, 3)).astype(np.float32) - 0.5) * 1.5
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _cuda(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


def _assert_closest(t, i, t_p, i_p):
    diff = i != i_p
    assert bool((t[diff] == t_p[diff]).all()), "idx differs without a t tie"
    assert int(diff.sum()) <= max(1, i.numel() // 10_000)
    hit = i_p >= 0
    assert torch.equal(t[hit], t_p[hit])


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("common_origin", [False, True])
def test_k1_matches_plain(cuda_scene, any_hit, common_origin):
    _, tables = cuda_scene
    n = 65_536
    o, d = _rays(10, n, common_origin)
    dead = np.arange(n) % 5 == 0
    tm = np.where(dead, 0.0, 1e30 if not any_hit else 1.8).astype(np.float32)
    og, dg, tmg = _cuda(o[:1] if common_origin else o, d, tm)
    kt.reset_launches()
    t, i = kt.trace_packets(tables, og, dg, tmg, any_hit, common_origin)
    assert kt.LAUNCHES["k1"] == 1
    t_p, i_p = kt.trace_packets_plain(tables, og, dg, tmg, any_hit,
                                      common_origin)
    torch.cuda.synchronize()
    if any_hit:
        assert torch.equal(i >= 0, i_p >= 0)
    else:
        _assert_closest(t, i, t_p, i_p)
    assert bool((i[torch.from_numpy(dead).cuda()] == -1).all())
    assert float((i_p >= 0).float().mean()) > 0.2


@pytest.mark.parametrize("ah", [(False, True, True), (True, True), (False,),
                                (True,)])
def test_k2_matches_plain(cuda_scene, ah):
    _, tables = cuda_scene
    n = 65_536
    rng = np.random.default_rng(11)
    o, d_b = _rays(11, n)
    d_e = rng.standard_normal((n, 3)).astype(np.float32)
    d_e /= np.linalg.norm(d_e, axis=-1, keepdims=True)
    d_p = -d_e + 0.3
    d_p /= np.linalg.norm(d_p, axis=-1, keepdims=True)
    live = np.arange(n) % 4 != 0
    tms = [np.where(live, 1e30, 0.0), np.where(live, 1e30, 0.0),
           np.where(np.arange(n) % 7 != 0, 1.2, 0.0)]
    dirs = [d_b, d_e, d_p][3 - len(ah):] if ah[0] else [d_b, d_e, d_p][:len(ah)]
    tms = [x.astype(np.float32) for x in tms[:len(ah)]]
    og = _cuda(o)[0]
    dg, tmg = _cuda(*dirs), _cuda(*tms)
    kt.reset_launches()
    got = kt.trace_multi(tables, og, dg, tmg, ah)
    assert kt.LAUNCHES["k2"] == 1
    ref = kt.trace_multi_plain(tables, og, dg, tmg, ah)
    torch.cuda.synchronize()
    for c, any_hit in enumerate(ah):
        if any_hit:
            assert torch.equal(got[c][1] >= 0, ref[c][1] >= 0)
        else:
            _assert_closest(got[c][0], got[c][1], ref[c][0], ref[c][1])


def test_wrappers_check_their_inputs(cuda_scene):
    _, tables = cuda_scene
    d = torch.zeros((8, 3), device="cuda")
    with pytest.raises(TypeError, match="dtype"):
        kt.trace_packets(tables, d.double(), d.double(), 1e30)
    with pytest.raises(ValueError, match="contiguous"):
        kt.trace_packets(tables, d, torch.zeros((3, 8), device="cuda").T, 1e30)
    with pytest.raises(ValueError, match="shape"):
        kt.trace_multi(tables, d, [d[:4]], [1e30], [False])


def test_frame_kernels_match_plain(cuda_scene):
    scene, _ = cuda_scene
    cfg = RenderConfig(width=128, height=96, enable_svgf=False,
                       compact_frac=0.0, compact_auto=False)
    cam = OrbitCamera(width=128, height=96, yaw_deg=20.0)
    kt.reset_launches()
    out_k = Renderer(scene, cfg).step(cam.snapshot("cuda"))
    assert kt.LAUNCHES["k1"] == 1 and kt.LAUNCHES["k2"] == cfg.max_tracing_depth
    out_p = Renderer(scene, cfg, tracer=kt.PLAIN).step(cam.snapshot("cuda"))
    d = (out_k.pt_color - out_p.pt_color).abs().amax(-1)
    assert float((d > 5e-4).float().mean()) <= 0.005
    assert float(d.max()) < 0.1
    assert bool(torch.isfinite(out_k.final).all())


def _denoise_inputs(seed, h=256, w=384):
    """Random K4 inputs: a smooth surface, motion with discontinuities (two
    blocks move against the rest), a sky band, history of 0..8 frames."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    n = np.zeros((h, w, 3), np.float32)
    n[..., 2] = 1.0
    n += 0.2 * rng.standard_normal((h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    z = (2.0 + 0.01 * xx + 0.02 * yy + 0.01 * rng.random((h, w))).astype(np.float32)
    z[:16] = 1.0
    n[:16] = 0.0
    mx = np.full((h, w), 1.6, np.float32) + 0.5 * rng.random((h, w)).astype(np.float32)
    my = np.full((h, w), -0.7, np.float32)
    mx[40:120, 50:200] = -6.3
    my[150:230, 100:300] = 9.2
    prev_z = z.copy()
    prev_z[60:90, 220:300] += 4.0
    f = lambda *s: rng.random(s).astype(np.float32)
    return dict(
        color=f(h, w, 3), emission=0.1 * f(h, w, 3), albedo=f(h, w, 3),
        motion=np.stack([mx / w, my / h], -1), normal=n, linear_z=z,
        fwidth_normal=0.01 + 0.1 * f(h, w), fwidth_z=0.005 + 0.03 * f(h, w),
        prev_illum=f(h, w, 3), prev_variance=f(h, w), prev_normal=n.copy(),
        prev_linear_z=prev_z, prev_moments=f(h, w, 2),
        prev_history_len=np.floor(9 * f(h, w)))


def _assert_close(got, ref, name):
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6, msg=name)


@pytest.mark.parametrize("quirks", [False, True])
def test_k4_matches_plain(cuda_scene, quirks):
    a = _denoise_inputs(12)
    a = dict(zip(a, _cuda(*a.values())))
    cfg = RenderConfig(width=384, height=256, reference_quirks=quirks)
    kr.reset_launches()
    got = kr.reproject_variance_fused(cfg, **a)
    assert kr.LAUNCHES["k4"] == 1
    ref = kr.reproject_variance_plain(cfg, **a)
    torch.cuda.synchronize()
    assert torch.equal(got.history_len, ref.history_len)
    for f in got._fields:
        _assert_close(getattr(got, f), getattr(ref, f), f)
    hl = ref.history_len[16:]
    assert bool((hl == 1).any()) and bool((hl > 4).any())  # both branches ran


@pytest.mark.parametrize("n_iters", [1, 2, 3, 4, 5])
def test_k5_steps_match_plain(cuda_scene, n_iters):
    """The chain through step 1 << (n_iters - 1), kernel against plain."""
    a = _denoise_inputs(13)
    illum, var, n, z, fwz = _cuda(a["prev_illum"] * 4.0, a["prev_variance"],
                                  a["normal"], a["linear_z"], a["fwidth_z"])
    for quirks in (False, True):
        cfg = RenderConfig(num_atrous_iterations=n_iters, reference_quirks=quirks)
        ka.reset_launches()
        (gi, gv), (ti, tv) = ka.atrous_chain(illum, var, n, z, fwz, cfg)
        assert ka.LAUNCHES["k5"] == n_iters
        (ri, rv), (rti, rtv) = ka.atrous_chain_plain(illum, var, n, z, fwz, cfg)
        torch.cuda.synchronize()
        for got, ref, name in ((gi, ri, "illum"), (gv, rv, "variance"),
                               (ti, rti, "tap illum"), (tv, rtv, "tap variance")):
            _assert_close(got, ref, f"{name} (quirks={quirks})")


def test_svgf_frames_kernels_match_plain(cuda_scene):
    scene, _ = cuda_scene
    cfg = RenderConfig(width=128, height=96, compact_frac=0.0, compact_auto=False)
    plain_cfg = RenderConfig(width=128, height=96, compact_frac=0.0,
                             compact_auto=False, pallas_denoise=False)
    rk = Renderer(scene, cfg)
    rp = Renderer(scene, plain_cfg, tracer=kt.PLAIN)
    cam = OrbitCamera(width=128, height=96, yaw_deg=20.0)
    kt.reset_launches()
    kr.reset_launches()
    ka.reset_launches()
    for _ in range(3):
        cam.rotate(0.5, 0.0)
        out_k, out_p = rk.step(cam.snapshot()), rp.step(cam.snapshot())
    assert kr.LAUNCHES["k4"] == 3 and ka.LAUNCHES["k5"] == 15
    assert kt.LAUNCHES["k1"] == 3
    d = (out_k.final - out_p.final).abs().amax(-1)
    assert float((d > 5e-4).float().mean()) <= 0.005
    assert float(d.max()) < 0.1
    assert bool(torch.isfinite(out_k.final).all())
    assert not torch.equal(out_k.final, out_k.pt_color)
