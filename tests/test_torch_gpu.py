"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips without a CUDA device. This file
imports no jax (the card's machine has none), so it runs there without
tests/conftest.py:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances: closest-hit idx and t exact (the kernels repeat the plain
version's float ops with FMA contraction off; a differing idx is allowed
only as an exact-t tie, which the walk order decides); any-hit hit/miss
exact."""
import numpy as np
import pytest
import torch

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
