"""The CUDA kernels against their plain PyTorch versions, on the card:
K1 (shared-origin primaries), K2 (fused bounce classes, and each class
against K3 on that class alone), K3 (per-ray origins), K4 and K5 (the
denoiser; also at ragged and tiny sizes and at 1080p, on sky, at every
history tap, and with no pixel and every pixel taking K4's fallback), K6
(chunked forests of 8 and 128 chunks), K7 (the one-hot
hi/lo gather), frames of every path through them, and a train step's
gradients through the traversal kernels against the plain tracer's.

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
within tests/test_dist_frame.py's image tolerance of the plain frame.
K7 bit-exact. Train-step gradients within 1e-4 of each field's largest
|gradient| (t and idx are bit-exact, but the backward of table[idx] on
CUDA sums with atomics, in an order that changes from run to run)."""
import dataclasses

import numpy as np
import pytest
import torch

from tpuray_torch.integrator.path_tracer import KERNELS, PLAIN, pack_traversal
from tpuray_torch.kernels import atrous as ka
from tpuray_torch.kernels import gather as kg
from tpuray_torch.kernels import reproject as kr
from tpuray_torch.kernels import trace as kt
from tpuray_torch.kernels import trace_chunked as ktc
from tpuray_torch.render.renderer import Renderer
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.procedural import make_large_scene, make_test_scene
from tpuray_torch.train import optimize

from tests.test_torch_denoise_tiles import _k4_inputs, _k5_inputs

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    scene = make_test_scene(subdiv=4, env_width=64, device="cuda")
    return scene, kt.pack_scene(scene.bvh, scene.triangles)


@pytest.fixture(scope="module")
def cuda_forest():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    scene = make_large_scene(n_spheres=8, subdiv=3, max_chunk_tris=2048,
                             env_width=64, device="cuda")
    return scene, pack_traversal(scene)


@pytest.fixture(scope="module")
def cuda_forest_64():
    """cuda_forest's geometry in 128 chunks (>= 64, as the 524k forest
    has): a top-level tree 7 levels deep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    scene = make_large_scene(n_spheres=8, subdiv=3, max_chunk_tris=128,
                             env_width=64, device="cuda")
    return scene, pack_traversal(scene)


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
@pytest.mark.parametrize("kernel", ["k1", "k3"])
def test_k1_matches_plain(cuda_scene, any_hit, kernel):
    """K1 (a shared origin) and K3 (per-ray origins, some inside boxes)."""
    _, tables = cuda_scene
    n = 65_536
    common_origin = kernel == "k1"
    o, d = _rays(10, n, common_origin)
    dead = np.arange(n) % 5 == 0
    tm = np.where(dead, 0.0, 1e30 if not any_hit else 1.8).astype(np.float32)
    og, dg, tmg = _cuda(o[:1] if common_origin else o, d, tm)
    kt.reset_launches()
    if common_origin:
        t, i = kt.trace_packets(tables, og, dg, tmg, any_hit, True)
    else:
        t, i = kt.trace_batched(tables, og, dg, tmg, any_hit)
    assert kt.LAUNCHES == {"k1": int(common_origin), "k2": 0,
                           "k3": int(not common_origin)}
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


@pytest.mark.parametrize("ah", [(False, True, True), (True, True), (False,)])
def test_k2_classes_equal_k3_alone(cuda_scene, ah):
    """K2 runs one thread per (ray, class) with K1's walk: each class is
    the trace_batched (K3) of that class alone, t and idx equal for a
    closest-hit class, hit/miss for an any-hit one."""
    _, tables = cuda_scene
    n = 65_536 + 77
    rng = np.random.default_rng(16)
    o, d_b = _rays(16, n)
    d_e = rng.standard_normal((n, 3)).astype(np.float32)
    d_e /= np.linalg.norm(d_e, axis=-1, keepdims=True)
    d_p = -d_e + 0.3
    d_p /= np.linalg.norm(d_p, axis=-1, keepdims=True)
    live = np.arange(n) % 3 != 0
    tms = {False: np.where(live, 1e30, 0.0), True: np.where(live, 1.5, 0.0)}
    dirs = [d_b, d_e, d_p][3 - len(ah):] if ah[0] else [d_b, d_e, d_p][:len(ah)]
    og = _cuda(o)[0]
    dg = _cuda(*dirs)
    tmg = _cuda(*[tms[a].astype(np.float32) for a in ah])
    got = kt.trace_multi(tables, og, dg, tmg, ah)
    for c, any_hit in enumerate(ah):
        t3, i3 = kt.trace_batched(tables, og, dg[c], tmg[c], any_hit)
        torch.cuda.synchronize()
        if any_hit:
            assert torch.equal(got[c][1] >= 0, i3 >= 0)
        else:
            assert torch.equal(got[c][0], t3) and torch.equal(got[c][1], i3)
        assert float((i3 >= 0).float().mean()) > 0.05


def test_wrappers_check_their_inputs(cuda_scene, cuda_forest):
    _, tables = cuda_scene
    _, forest = cuda_forest
    d = torch.zeros((8, 3), device="cuda")
    with pytest.raises(TypeError, match="dtype"):
        kt.trace_packets(tables, d.double(), d.double(), 1e30,
                         common_origin=True)
    with pytest.raises(ValueError, match="contiguous"):
        kt.trace_batched(tables, d, torch.zeros((3, 8), device="cuda").T, 1e30)
    with pytest.raises(ValueError, match="shape"):
        kt.trace_multi(tables, d, [d[:4]], [1e30], [False])
    with pytest.raises(ValueError, match="trace_batched"):
        kt.trace_packets(tables, d, d, 1e30)  # per-ray origins are K3's
    with pytest.raises(ValueError, match="forest"):
        kt.trace_batched(forest, d, d, 1e30)
    with pytest.raises(ValueError, match="forest"):
        ktc.trace_chunked(tables, d, d, 1e30)
    with pytest.raises(ValueError, match="shape"):
        ktc.trace_chunked(forest, d[:4], d, 1e30)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("common_origin", [False, True])
def test_k6_matches_plain(cuda_forest, any_hit, common_origin):
    _check_k6(cuda_forest[1], any_hit, common_origin)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("common_origin", [False, True])
def test_k6_many_chunks_matches_plain(cuda_forest_64, any_hit, common_origin):
    tables = cuda_forest_64[1]
    assert tables.n_chunks >= 64
    _check_k6(tables, any_hit, common_origin)


def _check_k6(tables, any_hit, common_origin):
    """K6 against its plain version: per-ray origins among the spheres or a
    camera-like shared one, dead lanes, closest or any hit."""
    n = 65_536 + 77
    rng = np.random.default_rng(14)
    o = np.tile(np.asarray([[0.4, 0.6, 3.5]], np.float32), (n, 1))
    if not common_origin:
        o = ((rng.random((n, 3)) - 0.5) * np.asarray([4.0, 1.5, 4.0])).astype(np.float32)
        o[: n // 8, 1] = -0.45  # just above the ground, among the spheres
    tgt = ((rng.random((n, 3)) - 0.5) * np.asarray([3.0, 1.2, 3.0])).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dead = np.arange(n) % 5 == 0
    # the camera-like origin sits ~3 from the field; the others among it
    shadow_tmax = 4.5 if common_origin else 1.5
    tm = np.where(dead, 0.0, 1e30 if not any_hit else shadow_tmax).astype(np.float32)
    og, dg, tmg = _cuda(o[:1] if common_origin else o, d, tm)
    ktc.reset_launches()
    t, i = ktc.trace_chunked(tables, og, dg, tmg, any_hit, common_origin)
    assert ktc.LAUNCHES["k6"] == 1
    t_p, i_p = ktc.trace_chunked_plain(tables, og, dg, tmg, any_hit,
                                       common_origin)
    torch.cuda.synchronize()
    if any_hit:
        assert torch.equal(i >= 0, i_p >= 0)
    else:
        _assert_closest(t, i, t_p, i_p)
    assert bool((i[torch.from_numpy(dead).cuda()] == -1).all())
    assert 0.1 < float((i_p >= 0).float().mean()) < 0.95


def test_frame_kernels_match_plain(cuda_scene):
    scene, _ = cuda_scene
    cfg = RenderConfig(width=128, height=96, enable_svgf=False,
                       compact_frac=0.0, compact_auto=False)
    cam = OrbitCamera(width=128, height=96, yaw_deg=20.0)
    kt.reset_launches()
    out_k = Renderer(scene, cfg).step(cam.snapshot("cuda"))
    assert kt.LAUNCHES["k1"] == 1 and kt.LAUNCHES["k2"] == cfg.max_tracing_depth
    out_p = Renderer(scene, cfg, tracer=PLAIN).step(cam.snapshot("cuda"))
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


def _chain_close(got, ref, name):
    (gi, gv), (ti, tv) = got
    (ri, rv), (rti, rtv) = ref
    for a, b, what in ((gi, ri, "illum"), (gv, rv, "variance"),
                       (ti, rti, "tap illum"), (tv, rtv, "tap variance")):
        _assert_close(a, b, f"{what} ({name})")


@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("h,w", [(61, 97), (1080, 1920), (5, 7), (2, 2), (1, 40)])
def test_k5_sizes_match_plain(cuda_scene, h, w, quirks):
    """The chain of 5 at ragged sizes, at 1080p, and on images smaller
    than the later steps' halo, kernel against plain."""
    args = _cuda(*_k5_inputs(h * w, h, w))
    cfg = RenderConfig(reference_quirks=quirks)
    ka.reset_launches()
    got = ka.atrous_chain(*args, cfg)
    assert ka.LAUNCHES["k5"] == 5
    ref = ka.atrous_chain_plain(*args, cfg)
    torch.cuda.synchronize()
    _chain_close(got, ref, f"{h}x{w}")


@pytest.mark.parametrize("case", ["all_sky", "sky_block", "sigma_n_3", "sigma_n_64"])
def test_k5_sky_and_sigma_match_plain(cuda_scene, case):
    """Sky everywhere (passthrough), one 32 x 8 block of sky, sigma_n = 3
    (the kernel's powf path) and sigma_n = 64 (six squarings)."""
    il, var, n, z, fwz = _k5_inputs(15, 64, 96)
    z[:8, :32] = 1.0
    if case == "all_sky":
        z[:] = 1.0
    cfg = RenderConfig(sigma_n={"sigma_n_3": 3.0, "sigma_n_64": 64.0}.get(case, 128.0))
    args = _cuda(il, var, n, z, fwz)
    got = ka.atrous_chain(*args, cfg)
    ref = ka.atrous_chain_plain(*args, cfg)
    torch.cuda.synchronize()
    _chain_close(got, ref, case)
    assert torch.equal(got[0][0][:8, :32], args[0][:8, :32])
    if case == "all_sky":
        assert torch.equal(got[0][0], args[0]) and torch.equal(got[0][1], args[1])


@pytest.mark.parametrize("tap", [0, 1, 4, 5])
def test_k5_history_tap_matches_plain(cuda_scene, tap):
    """The history tap at 0, 1, 4 and past the chain (the input itself)."""
    args = _cuda(*_k5_inputs(16, 96, 128))
    cfg = RenderConfig(history_atrous_tap=tap)
    got = ka.atrous_chain(*args, cfg)
    ref = ka.atrous_chain_plain(*args, cfg)
    torch.cuda.synchronize()
    _chain_close(got, ref, f"tap {tap}")
    assert (got[1][0] is args[0]) == (tap >= cfg.num_atrous_iterations)


@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("h,w,case", [(61, 97, "mixed"), (1080, 1920, "mixed"),
                                      (2, 2, "mixed"), (2, 2, "all"), (64, 96, "none"),
                                      (64, 96, "all")])
def test_k4_cases_match_plain(cuda_scene, h, w, case, quirks):
    """Ragged sizes, 1080p, 2 x 2, and no pixel or every pixel taking the
    variance fallback: kernel against plain, history_len exact."""
    a = _k4_inputs(h + w, h, w, case)
    a = dict(zip(a, _cuda(*a.values())))
    cfg = RenderConfig(width=w, height=h, reference_quirks=quirks)
    kr.reset_launches()
    got = kr.reproject_variance_fused(cfg, **a)
    assert kr.LAUNCHES["k4"] == 1
    ref = kr.reproject_variance_plain(cfg, **a)
    torch.cuda.synchronize()
    assert torch.equal(got.history_len, ref.history_len)
    for f in got._fields:
        _assert_close(getattr(got, f), getattr(ref, f), f)
    needs = (ref.history_len < 4) & (a["linear_z"] != 1.0)
    assert bool(needs.any()) == (case != "none")


@pytest.mark.parametrize("sigma_n", [3.0, 64.0])
def test_k4_sigma_n_matches_plain(cuda_scene, sigma_n):
    """The fallback's normal weight through powf (sigma_n = 3) and six
    squarings (64), kernel against plain."""
    a = _k4_inputs(7, 61, 97, "mixed")
    a = dict(zip(a, _cuda(*a.values())))
    cfg = RenderConfig(width=97, height=61, sigma_n=sigma_n)
    got = kr.reproject_variance_fused(cfg, **a)
    ref = kr.reproject_variance_plain(cfg, **a)
    torch.cuda.synchronize()
    assert torch.equal(got.history_len, ref.history_len)
    for f in got._fields:
        _assert_close(getattr(got, f), getattr(ref, f), f)


def test_svgf_frames_kernels_match_plain(cuda_scene):
    scene, _ = cuda_scene
    cfg = RenderConfig(width=128, height=96, compact_frac=0.0, compact_auto=False)
    plain_cfg = RenderConfig(width=128, height=96, compact_frac=0.0,
                             compact_auto=False, pallas_denoise=False)
    rk = Renderer(scene, cfg)
    rp = Renderer(scene, plain_cfg, tracer=PLAIN)
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


@pytest.mark.parametrize("case", ["forest", "separate_walk", "mis"])
def test_slice3_frames_match_plain(cuda_scene, cuda_forest, case):
    """Two moving SVGF frames per path, through the kernels and through the
    plain versions, with the launches of each path: 6 K6 a frame on a
    forest, 1 K1 + 5 K3 for the separate walks and for MIS."""
    scene = cuda_forest[0] if case == "forest" else cuda_scene[0]
    extra = {"separate_walk": {"fused_secondary": False},
             "mis": {"integrator": "mis"}}.get(case, {})
    kw = dict(width=128, height=96, compact_frac=0.0, compact_auto=False, **extra)
    rk = Renderer(scene, RenderConfig(**kw))
    rp = Renderer(scene, RenderConfig(pallas_denoise=False, **kw), tracer=PLAIN)
    cam = OrbitCamera(width=128, height=96, yaw_deg=20.0, radius=4.0)
    for m in (kt, ktc, kr, ka):
        m.reset_launches()
    for _ in range(2):
        cam.rotate(0.5, 0.0)
        out_k, out_p = rk.step(cam.snapshot()), rp.step(cam.snapshot())
    launches = {**kt.LAUNCHES, **ktc.LAUNCHES}
    want = (dict(k1=0, k2=0, k3=0, k6=12) if case == "forest"
            else dict(k1=2, k2=0, k3=10, k6=0))
    assert launches == want
    assert kr.LAUNCHES["k4"] == 2 and ka.LAUNCHES["k5"] == 10
    d = (out_k.final - out_p.final).abs().amax(-1)
    assert float((d > 5e-4).float().mean()) <= 0.005
    assert float(d.max()) < 0.1
    assert bool(torch.isfinite(out_k.final).all())
    assert 0.05 < float(out_k.coverage) < 1.0


@pytest.mark.parametrize("t_rows,w,n", [(1000, 26, 3000), (2048, 8, 4096),
                                        (600, 44, 777), (20482, 26, 65536)])
def test_k7_matches_plain(cuda_scene, t_rows, w, n):
    rng = np.random.default_rng(t_rows)
    table = rng.uniform(-8, 8, (t_rows, w)).astype(np.float32)
    table[0, :4] = [1.0 / 3.0, 0.1, 1e-40, -0.0]  # a third, a subnormal, -0
    idx = rng.integers(0, t_rows, n).astype(np.int32)
    idx[::9] = -1
    idx[1::9] = t_rows + 3
    idx[2::9] = 0
    tg, ig = _cuda(table, idx)
    kg.reset_launches()
    got = kg.onehot_gather(tg, ig)
    assert kg.LAUNCHES["k7"] == 1
    want = kg.onehot_gather_plain(tg, ig)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((got[::9] == 0).all()) and not torch.equal(got, tg[ig.clamp(0, t_rows - 1).long()])


def test_k7_checks_its_inputs(cuda_scene):
    table = torch.rand((16, 4), device="cuda")
    with pytest.raises(TypeError, match="dtype"):
        kg.onehot_gather(table, torch.arange(8, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        kg.onehot_gather(table.T.contiguous().T, torch.arange(8, device="cuda",
                                                             dtype=torch.int32))
    with pytest.raises(RuntimeError, match="forward-only"):
        kg.onehot_gather(table.requires_grad_(True),
                         torch.arange(8, device="cuda", dtype=torch.int32))


def test_train_step_kernels_match_plain(cuda_scene):
    """One make_train_step step at 64x64: the loss and every gradient
    through K1 + K2 equal the plain tracer's; K1 once and K2 twice."""
    scene, _ = cuda_scene
    h = w = 64
    cfg = RenderConfig(width=w, height=h, compact_frac=0.0, compact_auto=False)
    cam = OrbitCamera(width=w, height=h, yaw_deg=20.0).snapshot()
    params, rebuild = optimize.split_trainable(scene, device="cuda")
    with torch.no_grad():
        target = optimize.render_flat(rebuild(params), cam, cfg, h, w, 0)
    grads, losses = [], []
    for tracer in (KERNELS, PLAIN):
        params, rebuild = optimize.split_trainable(scene, device="cuda")
        with torch.no_grad():
            params["materials"].base_color.mul_(0.4).add_(0.3)
        init, step = optimize.make_train_step(
            rebuild, cfg, h, w, lambda p: torch.optim.SGD(p, lr=0.0), tracer=tracer)
        state = init(params)
        kt.reset_launches()
        state, loss = step(state, target, cam, 0)
        if tracer is KERNELS:
            assert kt.LAUNCHES == {"k1": 1, "k2": 2, "k3": 0}
        losses.append(loss)
        grads.append({f"{g}.{f.name}": getattr(t, f.name).grad
                      for g, t in state.params.items() for f in dataclasses.fields(t)})
    torch.testing.assert_close(losses[0], losses[1], rtol=1e-5, atol=0)
    for name, g in grads[0].items():
        ref = grads[1][name]
        assert bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()) + 1e-12, msg=name)
    assert float(grads[0]["materials.base_color"].abs().max()) > 0.0
