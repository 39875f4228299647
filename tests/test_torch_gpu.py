"""The CUDA kernels against their plain PyTorch versions, on the card:
K1 (shared-origin rays: random directions and tile-ordered camera
primaries; a float t_max copies nothing to the card, for K3 and K6
neither), K2 (fused bounce classes, and each class
against K3 on that class alone), K3 (per-ray origins over the wide
records; also the five walks of a separate-walk and a MIS frame), K4 and K5 (the
denoiser; also at ragged and tiny sizes and at 1080p, on sky, at every
history tap, with no pixel and every pixel taking K4's fallback, and on a
sharded frame's row window, with a motion beyond the halo too; under
the tile-windowed and the shifted-rescue reads, whole image and row
window), K6
(chunked forests of 8 and 128 chunks), K7 (the one-hot
hi/lo gather at each compile-time width and the run-time one, with ragged
N, a misaligned table and indices outside the table), frames of every path through them, and a train step's
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

from tpuray_torch.denoise.atrous import atrous_iteration
from tpuray_torch.integrator.path_tracer import (
    KERNELS, PLAIN, _compact_budget, pack_traversal)
from tpuray_torch.kernels import atrous as ka
from tpuray_torch.kernels import gather as kg
from tpuray_torch.kernels import reproject as kr
from tpuray_torch.kernels import trace as kt
from tpuray_torch.kernels import trace_chunked as ktc
from tpuray_torch.render.renderer import Renderer, camera_rays
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.procedural import make_large_scene, make_test_scene
from tpuray_torch.train import optimize
from tpuray_torch.traversal_times import k3_walks

from tests.test_torch_denoise_tiles import _k4_inputs, _k5_inputs, _slab

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
@pytest.mark.parametrize("kernel", ["k1", "k1 tiles", "k3"])
def test_k1_matches_plain(cuda_scene, any_hit, kernel):
    """K1 (a shared origin: random directions, and the tile-ordered
    primaries of an 800x800 camera, whose warps walk nearly one path) and
    K3 (per-ray origins, some inside boxes)."""
    _, tables = cuda_scene
    common_origin = kernel != "k3"
    if kernel == "k1 tiles":
        cam = OrbitCamera(width=800, height=800).snapshot("cuda")
        og, dg = camera_rays(cam, 800, 800)[:2]
        og = og[:1].contiguous()
        n = dg.shape[0]
    else:
        n = 65_536
        o, d = _rays(10, n, common_origin)
        og, dg = _cuda(o[:1] if common_origin else o, d)
    dead = np.arange(n) % 5 == 0
    tmg = _cuda(np.where(dead, 0.0, 1e30 if not any_hit else 1.8).astype(np.float32))[0]
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


def test_float_t_max_copies_nothing(cuda_scene, cuda_forest):
    """A float t_max reaches K1 as a kernel argument and K3 and K6 as an
    array filled in on the card: none of the three calls copies from the
    host (a pageable copy makes PyTorch wait for the stream), and each
    result is bit-equal to the same call with a per-ray tensor t_max."""
    from torch.profiler import ProfilerActivity, profile
    _, tables = cuda_scene
    _, forest = cuda_forest
    n = 65_536
    o, d = _rays(17, n, True)
    og, dg = _cuda(o[:1], d)
    orig_n = og.expand(n, 3).contiguous()
    tm = torch.full((n,), 1e30, device="cuda")
    calls = {
        "k1": lambda t_max: kt.trace_packets(tables, og, dg, t_max, False, True),
        "k3": lambda t_max: kt.trace_batched(tables, orig_n, dg, t_max),
        "k6": lambda t_max: ktc.trace_chunked(forest, og, dg, t_max, False, True),
    }
    names = {"k1": "trace_k1_warp", "k3": "trace_k3", "k6": "trace_k6"}
    for key, call in calls.items():
        call(1e30)  # built and warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            got = call(1e30)
            torch.cuda.synchronize()
        device = [e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        assert any(names[key] in name for name in device), (key, device)
        assert not [name for name in device if "HtoD" in name], (key, device)
        want = call(tm)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), key
        assert float((want[1] >= 0).float().mean()) > 0.2
    # the profiler does see such a copy
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.as_tensor(1e30, device="cuda")
        torch.cuda.synchronize()
    assert any("HtoD" in e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


@pytest.mark.parametrize("path", ["separate-walk", "MIS"])
def test_k3_frame_walks_match_plain(cuda_scene, path):
    """The five K3 walks of one 160x120 frame (traversal_times.k3_walks,
    recorded from trace_paths): each through the wide walk against the
    plain version, one launch a walk."""
    scene, tables = cuda_scene
    cfg = RenderConfig(width=160, height=120, compact_frac=0.0, compact_auto=False)
    cam = OrbitCamera(width=160, height=120, yaw_deg=20.0).snapshot("cuda")
    walks = [a for name, a in k3_walks(scene, cfg, tables, camera_rays(cam, 120, 160))
             if name.startswith(path)]
    assert len(walks) == 5
    for orig, d, tm, any_hit in walks:
        kt.reset_launches()
        t, i = kt.trace_batched(tables, orig, d, tm, any_hit)
        assert kt.LAUNCHES["k3"] == 1
        t_p, i_p = kt.trace_packets_plain(tables, orig, d, tm, any_hit)
        torch.cuda.synchronize()
        if any_hit:
            assert torch.equal(i >= 0, i_p >= 0)
        else:
            _assert_closest(t, i, t_p, i_p)
            assert torch.equal(t, t_p)
        assert bool((i[tm <= 0] == -1).all())


def test_k3_needs_wide_records(cuda_scene):
    _, tables = cuda_scene
    d = torch.zeros((8, 3), device="cuda")
    with pytest.raises(ValueError, match="wide records"):
        kt.trace_batched(dataclasses.replace(tables, wide=None), d, d, 1e30)


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


@pytest.mark.parametrize("read", ["tiled", "fast"])
@pytest.mark.parametrize("quirks", [False, True])
def test_k4_reads_match_plain(cuda_scene, read, quirks):
    """K4's tile-windowed rule (the TPU kernel's geometry: 256 x 384 is
    8 x 3 tiles) and its shifted-rescue rule against their plain versions,
    one launch each; the inputs' moving block tears the motion field."""
    a = _denoise_inputs(14)
    a = dict(zip(a, _cuda(*a.values())))
    kw = dict(reproject_gather="tiled") if read == "tiled" else dict(fast_reproject=True)
    cfg = RenderConfig(width=384, height=256, reference_quirks=quirks, **kw)
    kr.reset_launches()
    got = kr.reproject_variance_fused(cfg, **a)
    assert kr.LAUNCHES["k4"] == 1
    ref = kr.reproject_variance_plain(cfg, **a)
    torch.cuda.synchronize()
    assert torch.equal(got.history_len, ref.history_len)
    for f in got._fields:
        _assert_close(getattr(got, f), getattr(ref, f), f)
    exact = kr.reproject_variance_fused(RenderConfig(width=384, height=256,
                                                     reference_quirks=quirks), **a)
    assert not torch.equal(exact.history_len, got.history_len)  # another read


@pytest.mark.parametrize("shard", [0, 1, 3])
def test_k4_tiled_row_window_matches_plain(cuda_scene, shard):
    """K4's tile-windowed rule on one of 4 shards of 64 rows extended by
    the halo 32 (as svgf_pipeline runs it) against its plain version,
    tpuray's sharded stage: the tiles start at the extended rows' first."""
    a = _denoise_inputs(22)
    full = dict(zip(a, _cuda(*a.values())))
    h, rows, k = 256, 64, 32
    row0 = shard * rows - k
    s = {n: _slab(x, row0, rows + 2 * k) for n, x in full.items()}
    cfg = RenderConfig(width=384, height=h, reproject_gather="tiled")
    kr.reset_launches()
    got = kr.reproject_variance_fused(cfg, row_window=(row0, h), **s)
    assert kr.LAUNCHES["k4"] == 1
    ref = kr.reproject_variance_plain(cfg, row_window=(row0, h), **s)
    torch.cuda.synchronize()
    assert torch.equal(got.history_len, ref.history_len)
    for f in got._fields:
        _assert_close(getattr(got, f), getattr(ref, f), f)


@pytest.mark.parametrize("n_iters", [1, 2, 3, 4, 5])
def test_k5_steps_match_plain(cuda_scene, n_iters):
    """The chain through step 1 << (n_iters - 1), kernel against plain."""
    a = _denoise_inputs(13)
    illum, var, n, z, fwz = _cuda(a["prev_illum"] * 4.0, a["prev_variance"],
                                  a["normal"], a["linear_z"], a["fwidth_z"])
    for quirks in (False, True):
        cfg = RenderConfig(num_atrous_iterations=n_iters, reference_quirks=quirks)
        ka.reset_launches()
        (gi, gv), (ti, tv) = ka.chain(ka.atrous_step, illum, var, n, z, fwz, cfg)
        assert ka.LAUNCHES["k5"] == n_iters
        (ri, rv), (rti, rtv) = ka.chain(atrous_iteration, illum, var, n, z, fwz, cfg)
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
    got = ka.chain(ka.atrous_step, *args, cfg)
    assert ka.LAUNCHES["k5"] == 5
    ref = ka.chain(atrous_iteration, *args, cfg)
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
    got = ka.chain(ka.atrous_step, *args, cfg)
    ref = ka.chain(atrous_iteration, *args, cfg)
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
    got = ka.chain(ka.atrous_step, *args, cfg)
    ref = ka.chain(atrous_iteration, *args, cfg)
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


@pytest.mark.parametrize("shard,halo", [(0, 32), (1, 32), (3, 32), (3, 4), (3, 2)])
def test_k4_row_window_matches_plain(cuda_scene, shard, halo):
    """K4 on one of 4 shards of 64 rows, extended by halo + 3 (as the
    sharded frame runs it), against its plain version with the same
    window: history_len exact, every output within rtol 1e-5; at halo 32
    every tap lies inside and the cropped rows equal the whole image's K4;
    at halos 4 and 2 the block moving 9.2 rows (rows 150-229) sends the
    taps of the last shard's first rows above its rows, which fail their
    reprojection on both sides."""
    a = _denoise_inputs(21)
    full = dict(zip(a, _cuda(*a.values())))
    h, rows, k = 256, 64, halo + 3
    row0 = shard * rows - k
    s = {n: _slab(x, row0, rows + 2 * k) for n, x in full.items()}
    cfg = RenderConfig(width=384, height=h)
    kr.reset_launches()
    got = kr.reproject_variance_fused(cfg, row_window=(row0, h), **s)
    assert kr.LAUNCHES["k4"] == 1
    ref = kr.reproject_variance_plain(cfg, row_window=(row0, h), **s)
    whole = kr.reproject_variance_fused(cfg, **full)
    torch.cuda.synchronize()
    assert torch.equal(got.history_len, ref.history_len)
    for f in got._fields:
        _assert_close(getattr(got, f), getattr(ref, f), f)
    crop = {f: getattr(got, f)[k:-k] for f in got._fields}
    mine = {f: getattr(whole, f)[shard * rows:(shard + 1) * rows] for f in got._fields}
    if halo == 32:
        for f in got._fields:
            assert torch.equal(crop[f], mine[f]), f
    else:
        lost = (crop["history_len"] == 1) & (mine["history_len"] != 1)
        assert bool(lost.any())


@pytest.mark.parametrize("shard", [0, 1, 3])
def test_k5_row_window_matches_plain(cuda_scene, shard):
    """Each iteration of the chain on one of 4 shards of 64 rows, extended
    by 2 * step + 1 (as the sharded frame runs it), against its plain
    version with the same window and, cropped, against the whole image's
    iteration, within rtol 1e-5; one launch each."""
    il, var, n, z, fwz = _cuda(*_k5_inputs(22, 256, 384))
    cfg = RenderConfig()
    rows = 64
    for i in range(cfg.num_atrous_iterations):
        step = 1 << i
        k = 2 * step + 1
        row0 = shard * rows - k
        s = [_slab(x, row0, rows + 2 * k) for x in (il, var, n, z, fwz)]
        ka.reset_launches()
        got = ka.atrous_step(*s, step, cfg, row_window=(row0, 256))
        assert ka.LAUNCHES["k5"] == 1
        ref = atrous_iteration(*s, step, cfg, row_window=(row0, 256))
        whole = ka.atrous_step(il, var, n, z, fwz, step, cfg)
        torch.cuda.synchronize()
        for a, b, w_, name in zip(got, ref, whole, ("illum", "variance")):
            _assert_close(a, b, f"{name}, step {step}")
            _assert_close(a[k:-k], w_[shard * rows:(shard + 1) * rows],
                          f"{name}, step {step}, against the whole image")
        il, var = whole


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
                                        (600, 44, 777), (20482, 26, 65536),
                                        (7, 18, 65_536 + 13), (300, 18, 31),
                                        (11_000, 44, 100_003), (513, 27, 95),
                                        (64, 1, 1000), (40, 130, 333)])
def test_k7_matches_plain(cuda_scene, t_rows, w, n):
    """Each compile-time width (26, 18, 44) and the run-time one, with N
    that leaves a warp's last rows empty."""
    rng = np.random.default_rng(t_rows)
    table = rng.uniform(-8, 8, (t_rows, w)).astype(np.float32)
    table[0, :4] = [1.0 / 3.0, 0.1, 1e-40, -0.0][:w]  # a third, a subnormal, -0
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


@pytest.mark.parametrize("w", [18, 26, 44, 7])
def test_k7_out_of_range_and_misaligned(cuda_scene, w):
    """Indices outside [0, T) at both ends of int32 give zero rows; a table
    that starts 4 bytes into its storage (too little alignment for vector
    loads) takes the run-time instance with the same result."""
    t_rows = 97
    rng = np.random.default_rng(w)
    store = torch.from_numpy(rng.uniform(-8, 8, (t_rows + 1) * w + 1).astype(np.float32)).cuda()
    idx = torch.from_numpy(np.asarray(
        [0, t_rows - 1, t_rows, -1, -t_rows, 2 ** 31 - 1, -2 ** 31, 5] * 9, np.int32)).cuda()
    bad = (idx < 0) | (idx >= t_rows)
    for table in (store[:t_rows * w].view(t_rows, w), store[1:1 + t_rows * w].view(t_rows, w)):
        got = kg.onehot_gather(table, idx)
        want = kg.onehot_gather_plain(table, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert bool((got[bad] == 0).all()) and bool((got[~bad] != 0).all())


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


@pytest.mark.parametrize("frac,residual", [(0.75, False), (0.125, True)],
                         ids=["fits", "residual"])
@pytest.mark.parametrize("case", ["tree", "forest"])
def test_compacted_frames_match_plain(cuda_scene, cuda_forest, case, frac, residual):
    """Two moving SVGF frames with bounce compaction through the kernels,
    against the plain versions and against the uncompacted kernel frames,
    with the launches: K2 on the budget's lanes (2 a frame, 4 with the
    residual pass) on a single tree, K6 on a forest (6 a frame, 11). About
    half the lanes hit: a budget of 3/4 of them holds them, 1/8 does not."""
    scene, _ = cuda_forest if case == "forest" else cuda_scene
    size = 128
    cfg = RenderConfig(width=size, height=size, compact_frac=frac, compact_auto=False)
    rk = Renderer(scene, cfg)
    rp = Renderer(scene, dataclasses.replace(cfg, pallas_denoise=False), tracer=PLAIN)
    r0 = Renderer(scene, dataclasses.replace(cfg, compact_frac=0.0))
    cam = OrbitCamera(width=size, height=size, radius=4.0 if case == "forest" else 2.0)
    budget = _compact_budget(size * size, cfg)
    for _ in range(2):
        cam.rotate(0.5, 0.0)
        kt.reset_launches()
        ktc.reset_launches()
        out_k = rk.step(cam.snapshot())
        launches = {**kt.LAUNCHES, **ktc.LAUNCHES}
        out_p, out_0 = rp.step(cam.snapshot()), r0.step(cam.snapshot())
        n_hit = round(float(out_k.coverage) * size * size)
        assert (n_hit > budget) == residual
        extra = 1 if residual else 0
        if case == "forest":
            assert launches["k6"] == 6 + 5 * extra and launches["k2"] == 0
        else:
            assert launches["k1"] == 1 and launches["k2"] == 2 + 2 * extra
        for ref in (out_p, out_0):
            d = (out_k.final - ref.final).abs().amax(-1)
            assert float((d > 5e-4).float().mean()) <= 0.005
            assert float(d.max()) < 0.1
        assert bool(torch.isfinite(out_k.final).all())
        assert float(out_k.coverage) == float(out_0.coverage)


def test_lagged_coverage_copy(cuda_scene):
    """The Renderer's coverage read: a pinned host copy behind an event,
    equal to the device value, read without .item()."""
    from tpuray_torch.render.renderer import LaggedScalar
    x = torch.rand((), device="cuda")
    lag = LaggedScalar(x)
    assert lag.read() == float(x.cpu())


def test_spans_stay_on_the_host(cuda_scene):
    """A compacted frame's spans (utils/metrics.py) in a traced session as
    the benchmark takes it (portbench/traceread.py: padded, rerun while a
    kernel record was lost): each a host op, none among the device
    operations, which are the same kernels as the frame's with the spans
    switched off."""
    from portbench import traceread
    from tpuray_torch.utils import metrics
    scene, _ = cuda_scene
    cfg = RenderConfig(width=128, height=128, compact_frac=0.5, compact_auto=False)
    r = Renderer(scene, cfg)
    cam = OrbitCamera(width=128, height=128)
    r.step(cam.snapshot("cuda"))

    def traced():
        prof, _, _ = traceread.profiled(lambda: r.step(cam.snapshot("cuda")))
        tr = traceread.Trace.of(prof)
        return [n for n, _, _ in tr.device_ops], {n for n, _, _ in tr.host_ops}

    dev, host = traced()
    assert not [n for n in dev if n.startswith("tpuray.")]
    assert {"tpuray.frame", "tpuray.trace_paths", "tpuray.wait.hit_count", "tpuray.svgf",
            "tpuray.taa"} <= host
    n, budget = 128 * 128, _compact_budget(128 * 128, cfg)
    rec = metrics.frame_records()[-1]
    assert rec["lanes"] == n and rec["shaded_lanes"] == budget + (n if rec["residual"] else 0)
    real = metrics._profiling
    metrics._profiling = lambda: False
    try:
        dev_off, host_off = traced()
    finally:
        metrics._profiling = real
    assert not [n for n in host_off if n.startswith("tpuray.")]
    assert sorted(dev) == sorted(dev_off)


# ---- distribution: one NCCL rank on the card (NCCL puts one rank on a card)


@pytest.fixture(scope="module")
def nccl_mesh(cuda_scene, tmp_path_factory):
    """A process group of one NCCL rank (a file store), left at the end."""
    from tpuray_torch.dist import multihost
    store = tmp_path_factory.mktemp("nccl") / "store"
    assert multihost.initialize(f"file://{store}", 1, 0, device="cuda") is False
    yield multihost.global_mesh()
    multihost.shutdown()


def test_nccl_render_tiled_matches_trace_paths(cuda_scene, nccl_mesh):
    """render_tiled on one NCCL rank equals the single-device row-major
    trace bit for bit; K1 once, K2 twice (depth 2)."""
    from tpuray_torch.dist.sharding import gather_rows, render_tiled
    from tpuray_torch.integrator.path_tracer import trace_paths
    scene, _ = cuda_scene
    n = 128
    cfg = RenderConfig(width=n, height=n, compact_frac=0.0, compact_auto=False)
    cam = OrbitCamera(width=n, height=n).snapshot("cuda")
    kt.reset_launches()
    color, _, albedo = render_tiled(scene, cam, cfg, nccl_mesh, n, n, frame=3)
    assert kt.LAUNCHES == {"k1": 1, "k2": 2, "k3": 0}
    yy, xx = torch.meshgrid(torch.arange(n, device="cuda"), torch.arange(n, device="cuda"),
                            indexing="ij")
    ref = trace_paths(scene, cam.eye[None], cam.ray_directions(n, n).reshape(-1, 3),
                      xx.reshape(-1), (n - 1 - yy).reshape(-1), 3, cfg, common_origin=True)
    assert torch.equal(gather_rows(nccl_mesh, color, n), ref.color.reshape(n, n, 3))
    assert torch.equal(albedo, ref.albedo.reshape(n, n, 3))


@pytest.mark.parametrize("pallas", [True, False])
def test_nccl_sharded_frames_match_render_frame(cuda_scene, nccl_mesh, pallas):
    """Three moving frames and a still one (static_camera=True) of
    render_frame_sharded on one NCCL rank equal render_frame under the same
    config bit for bit: K1 1 and K2 2 a frame, and K4 1 and K5 an iteration
    under RenderConfig()'s denoiser (pallas_denoise, where the still frame
    takes K4 at zero motion), none under the plain stages."""
    from tpuray_torch.dist.frame import render_frame_sharded, shard_state
    from tpuray_torch.render.frame_state import FrameState
    from tpuray_torch.render.renderer import render_frame
    scene, _ = cuda_scene
    n = 128
    cfg = RenderConfig(width=n, height=n, compact_frac=0.0, compact_auto=False,
                       pallas_denoise=pallas)
    tables = pack_traversal(scene)
    cam = OrbitCamera(width=n, height=n)
    s1 = FrameState.initial(n, n, "cuda")
    s2 = shard_state(FrameState.initial(n, n), nccl_mesh)
    k45 = dict(k4=1, k5=cfg.num_atrous_iterations) if pallas else dict(k4=0, k5=0)
    for rot, still in ((0.5, False), (0.5, False), (0.5, False), (0.0, True)):
        cam.rotate(rot, 0.0)
        snap = cam.snapshot("cuda")
        with torch.no_grad():
            s1, out = render_frame(scene, snap, s1, cfg, n, n, tables=tables,
                                   static_camera=still)
            kt.reset_launches()
            ka.reset_launches()
            kr.reset_launches()
            s2, final, pt_color = render_frame_sharded(scene, snap, s2, cfg, n, n, nccl_mesh,
                                                       static_camera=still, tables=tables)
        assert {**kt.LAUNCHES, **ka.LAUNCHES, **kr.LAUNCHES} == dict(k1=1, k2=2, k3=0, **k45)
        assert torch.equal(final, out.final) and torch.equal(pt_color, out.pt_color)
        assert torch.equal(s2.history_len, s1.history_len)


def test_nccl_check_job_frames(cuda_scene, nccl_mesh, tmp_path):
    """`python -m tpuray_torch.dist.dryrun N --check`'s "frames" part on one
    NCCL rank, under both denoisers (dryrun.DENOISERS): the moving frames
    and the still one (static_camera=True, K4 at zero motion under the
    kernel denoiser) bit-equal to render_frame's on the same camera path,
    the compacted frames finite; K4 1 and K5 an iteration a frame."""
    from tpuray_torch.dist import dryrun
    from tpuray_torch.render.frame_state import FrameState
    from tpuray_torch.render.renderer import render_frame
    out = tmp_path / "check.npz"
    kr.reset_launches()
    ka.reset_launches()
    dryrun.check_job(nccl_mesh, str(out), parts=("frames",))
    n_it = dryrun.CHECK_CFG["num_atrous_iterations"]
    assert (kr.LAUNCHES["k4"], ka.LAUNCHES["k5"]) == (6, 6 * n_it)  # 3 runs of 2 frames
    res = np.load(out)
    n = dryrun.CHECK_SIZE
    scene = dryrun.check_scene("cuda")
    for den, pallas in dryrun.DENOISERS.items():
        cfg = RenderConfig(width=n, height=n, pallas_denoise=pallas, **dryrun.CHECK_CFG)
        for key, rotations, still_last in (("moving", dryrun.CHECK_ROTATIONS, False),
                                           ("static", (0.0, 0.0), True)):
            cam = OrbitCamera(width=n, height=n)
            state = FrameState.initial(n, n, "cuda")
            for i, rot in enumerate(rotations):
                still = still_last and i == len(rotations) - 1
                cam.rotate(0.0 if still else rot, 0.0)
                with torch.no_grad():
                    state, ref = render_frame(scene, cam.snapshot("cuda"), state, cfg, n, n,
                                              static_camera=still)
                name = f"{den}_{key}_final_{i}"
                if name in res.files:
                    np.testing.assert_array_equal(res[name], ref.final.cpu().numpy(),
                                                  err_msg=name)
        for i in range(len(dryrun.CHECK_ROTATIONS)):
            assert np.isfinite(res[f"{den}_compact_final_{i}"]).all()


def test_nccl_sharded_train_step_matches_single(cuda_scene, nccl_mesh):
    """One SGD step of make_sharded_train_step on one NCCL rank (its
    all-reduce a collective of one): the loss and every gradient within
    1e-5 of make_train_step's (largest |gradient| per field)."""
    scene, _ = cuda_scene
    n = 64
    cfg = RenderConfig(width=n, height=n, compact_frac=0.0, compact_auto=False)
    cam = OrbitCamera(width=n, height=n, yaw_deg=20.0).snapshot("cuda")
    target = torch.full((n, n, 3), 0.3, device="cuda")
    out = []
    for sharded in (False, True):
        params, rebuild = optimize.split_trainable(scene, device="cuda")
        opt = lambda p: torch.optim.SGD(p, lr=0.1)  # noqa: E731
        init, step = (optimize.make_sharded_train_step(rebuild, cfg, n, n, nccl_mesh, opt)
                      if sharded else optimize.make_train_step(rebuild, cfg, n, n, opt))
        state, loss = step(init(params), target, cam, 0)
        out.append((loss, {f"{g}.{f.name}": getattr(t, f.name).grad
                           for g, t in state.params.items() for f in dataclasses.fields(t)}))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-6, atol=0)
    for name, ref in out[0][1].items():
        torch.testing.assert_close(out[1][1][name], ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()) + 1e-12, msg=name)


def test_elastic_resume_on_the_card(cuda_scene, tmp_path):
    """run_elastic over card frames with an injected CUDA fault resumes
    bit for bit equal to an uninterrupted run."""
    from tpuray_torch.render.frame_state import FrameState
    from tpuray_torch.render.renderer import render_frame
    from tpuray_torch.utils.elastic import run_elastic
    scene, _ = cuda_scene
    n = 64
    cfg = RenderConfig(width=n, height=n, compact_frac=0.0, compact_auto=False)
    cam = OrbitCamera(width=n, height=n)

    @torch.no_grad()
    def frame_fn(state, frame):
        cam.yaw_deg = 0.5 * frame
        return render_frame(scene, cam.snapshot("cuda"), state, cfg, n, n)[0]

    armed = {3}

    def flaky(state, frame):
        if frame in armed:
            armed.discard(frame)
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return frame_fn(state, frame)

    s0 = FrameState.initial(n, n, "cuda")
    ref, _ = run_elastic(frame_fn, s0, 5, str(tmp_path / "a.npz"), checkpoint_every=2)
    got, stats = run_elastic(flaky, s0, 5, str(tmp_path / "b.npz"), checkpoint_every=2)
    assert (stats.faults, stats.restores) == (1, 1)
    assert got.taa_color.device.type == "cuda"
    for f in ("taa_color", "illum_hist", "history_len", "moments", "accum_color"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_native_library_loads(cuda_scene):
    """The card's machine has g++ (nvcc needs it): the host builders take
    the native library there, and its BVH is the numpy builder's tree."""
    from tpuray_torch.io import native
    from tpuray_torch.scene.host import build_bvh_py
    assert native.available(), native.build_log
    tris = np.random.default_rng(0).random((500, 3, 3)).astype(np.float32)
    got, want = native.build_bvh_native(tris, 8), build_bvh_py(tris, 8)
    for k in ("first_tri", "tri_count", "skip", "perm"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_viewer_frames_on_the_card(cuda_scene):
    """Viewer frames on cuda: K1 1, K2 2, K4 1 and K5 5 a frame; a
    parameter event reaches the next frame (K5 follows
    num_atrous_iterations; accumulation restarts); the frame after it, with
    the camera still, runs K4 too (no plain static-camera branch on the
    card)."""
    from tpuray_torch.viewer.server import ViewerServer
    scene, _ = cuda_scene
    n = 64
    s = ViewerServer(scene, RenderConfig(width=n, height=n, compact_frac=0.0,
                                         compact_auto=False), port=0)
    counts = []
    for event in (None, {"type": "param", "name": "num_atrous_iterations", "value": 3}, None):
        if event:
            s.submit(event)
        for c in (kt, kr, ka):
            c.reset_launches()
        png, stats = s.render_once()
        counts.append((kt.LAUNCHES["k1"], kt.LAUNCHES["k2"], kr.LAUNCHES["k4"],
                       ka.LAUNCHES["k5"], stats["frame"]))
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert counts == [(1, 2, 1, 5, 1), (1, 2, 1, 3, 1), (1, 2, 1, 3, 2)]


def test_train_step_through_the_cli(cuda_scene, tmp_path):
    """One train step through the CLI on the card (its default device)."""
    from tpuray_torch.cli.main import main
    from tpuray_torch.io.image import read_png
    prefix = str(tmp_path / "t")
    kt.reset_launches()
    assert main(["train", "--size", "32", "--steps", "1", "--out-prefix", prefix]) == 0
    assert kt.LAUNCHES["k1"] >= 2  # the target, the step, the fit
    img = read_png(prefix + "_fit.png")
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
