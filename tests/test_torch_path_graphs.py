"""The path tracer's CUDA graphs (integrator/path_graphs.py:PathGraphs) on the CPU.

A CUDA graph needs the card (tests/test_torch_gpu.py replays real ones);
here a stand-in part captures by running the part's function and replays
by running it again into the captured outputs, with the launch counters
left as a graph replay leaves them (untouched). So PathGraphs' logic runs
here as on the card: the staged frame scalars, the parts A, B, B' and U,
the hit-count read between A and B, the launch tallies, the counters, the
key's eviction. The staged RNG keys are held bit-equal to the host ints
they replace; every replayed frame is held bit-equal to trace_paths.
"""
import gc

import numpy as np
import pytest
import torch

from tpuray_torch import kernels
from tpuray_torch.integrator import path_graphs as pg
from tpuray_torch.integrator import path_tracer as pt
from tpuray_torch.kernels import trace as kt
from tpuray_torch.kernels import trace_chunked as ktc
from tpuray_torch.render.renderer import Renderer, camera_rays
from tpuray_torch.sampling import rng
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.procedural import make_large_scene, make_test_scene
from tpuray_torch.utils import metrics

torch.set_num_threads(2)

SIZE = 64  # a whole number of 32x32 tiles: the frame's lanes are its pixels
FRAMES = [0, 1, 2**31 + 5, 2**32 - 1]


# ---- the staged RNG keys


def _pixels(coherent: bool):
    g = np.random.default_rng(7)
    px = torch.from_numpy(g.integers(0, 4096, 2000).astype(np.int32))
    py = torch.from_numpy(g.integers(0, 4096, 2000).astype(np.int32))
    if coherent:  # the tile streams' keys (path_tracer._shade_loop)
        px = px.to(torch.int64) // 32 + 0x8000
        py = py.to(torch.int64) // 32 + 0x8000
    return px, py


@pytest.mark.parametrize("coherent", [False, True], ids=["plain", "tile"])
@pytest.mark.parametrize("frame", FRAMES)
def test_staged_keys_bit_equal(frame, coherent):
    """A staged frame's keys (the device block's int64 term and float32
    Sobol points) give pixel_seed's bits, the same rand streams and the
    same rotated points as the host ints and numpy points, bounces 0-3,
    frame 2**32 - 1 wrapping to a Sobol index of 0."""
    depth = 4
    block = pg.FrameBlock(depth, "cpu")
    cam = OrbitCamera(width=SIZE, height=SIZE).snapshot()
    block.stage(frame, cam)
    keys = block.keys
    assert keys.seed_term.dtype == torch.int64 and keys.seed_term.dim() == 0
    px, py = _pixels(coherent)
    staged = rng.keyed_seed(px, py, keys.seed_term)
    host = rng.pixel_seed(px, py, frame)
    assert torch.equal(staged, host)
    a, b = staged, host
    for _ in range(5):
        ua, a = rng.rand(a)
        ub, b = rng.rand(b)
        assert torch.equal(ua.view(torch.int32), ub.view(torch.int32))
    cu, cv = rng.cranley_patterson_offsets(px, py)
    for bounce in range(depth):
        want = rng.sobol_vec2(frame + 1, bounce)
        got = keys.sobol[bounce]
        assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
        xa, ya = rng.cranley_patterson_rotate(got, cu, cv)
        xb, yb = rng.cranley_patterson_rotate(want, cu, cv)
        assert torch.equal(xa.view(torch.int32), xb.view(torch.int32))
        assert torch.equal(ya.view(torch.int32), yb.view(torch.int32))
    if frame == 2**32 - 1:
        assert not keys.sobol.any()  # gray_code(0): the zero point
    for name, _ in pg._CAMERA:
        assert torch.equal(getattr(block.camera, name), getattr(cam, name)), name


def test_blocks_alternate():
    """Two frames staged back to back land in different host blocks, and
    the device block holds the last one."""
    block = pg.FrameBlock(2, "cpu")
    cam = OrbitCamera(width=SIZE, height=SIZE).snapshot()
    block.stage(3, cam)
    first = block.keys.seed_term.item()
    block.stage(4, cam)
    assert first == rng.seed_term(3) and block.keys.seed_term.item() == rng.seed_term(4)
    assert block._views[0][0][0] == rng.seed_term(3)
    assert block._views[1][0][0] == rng.seed_term(4)


# ---- where graphs engage


@pytest.mark.parametrize("case", ["engages", "grad", "cpu", "plain", "mis"])
def test_engagement_rule(case):
    """Graphs engage on a CUDA device, through the kernels, for NEE, with
    grad off; never under grad, on the CPU, with PLAIN or for MIS. The
    rule reads only what it is given (no card needed)."""
    device, tracer, cfg = "cuda", pt.KERNELS, RenderConfig()
    if case == "cpu":
        device = "cpu"
    elif case == "plain":
        tracer = pt.PLAIN
    elif case == "mis":
        cfg = RenderConfig(integrator="mis")
    with torch.set_grad_enabled(case == "grad"):
        assert pg.engages(device, tracer, cfg) == (case == "engages")


def test_cpu_renderer_stays_eager():
    scene = make_test_scene(subdiv=1, env_width=32)
    r = Renderer(scene, RenderConfig(width=32, height=32), device="cpu")
    r.step(OrbitCamera(width=32, height=32).snapshot())
    assert r._graphs is None


# ---- PathGraphs, with a stand-in for the CUDA graph


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _leaves(y)]


class StandIn:
    """A part captured by running fn, replayed by running it again into
    the captured outputs; launches counted as a graph replay counts them
    (not at all: PathGraphs adds the tally). reset() marks it destroyed,
    and checks that the destruction holds the capture lock."""

    made: list = []
    check = None  # called at each capture

    @staticmethod
    def new_pool(device):
        return None

    def __init__(self, fn, pool):
        if StandIn.check is not None:
            StandIn.check()
        self.fn = fn
        self.out = fn()
        self.tally = {}
        self.destroyed = False
        StandIn.made.append(self)

    def replay(self):
        assert not self.destroyed
        saved = {m: dict(m.LAUNCHES) for m in kernels._counted()}
        new = self.fn()
        for m, v in saved.items():
            m.LAUNCHES.update(v)
        for dst, src in zip(_leaves(self.out), _leaves(new)):
            if dst is not src:
                dst.copy_(src)

    def reset(self):
        assert pg._CAPTURE._is_owned() and not self.destroyed
        self.destroyed = True


def _counting(fn, module, key):
    def f(*a, **k):
        module.LAUNCHES[key] += 1
        return fn(*a, **k)
    return f


# the plain walks, counted as the kernels count theirs
COUNTING = pt.Tracer(packets=_counting(pt.PLAIN.packets, kt, "k1"),
                     batched=_counting(pt.PLAIN.batched, kt, "k3"),
                     multi=_counting(pt.PLAIN.multi, kt, "k2"),
                     chunked=_counting(pt.PLAIN.chunked, ktc, "k6"))


@pytest.fixture(scope="module")
def tree():
    scene = make_test_scene(subdiv=2, env_width=32)
    return scene, pt.pack_traversal(scene), pt.pack_scene_tables(scene)


@pytest.fixture(scope="module")
def forest():
    scene = make_large_scene(n_spheres=4, subdiv=2, max_chunk_tris=512, env_width=32)
    return scene, pt.pack_traversal(scene), pt.pack_scene_tables(scene)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(pg, "GraphPart", StandIn)
    StandIn.made, StandIn.check = [], None
    yield StandIn
    StandIn.made, StandIn.check = [], None


@pytest.fixture
def record(monkeypatch):
    """An open frame record, as a profiled frame has (metrics.count)."""
    def fresh():
        r = dict(frame_idx=None, lanes=0, shaded_lanes=0, residual=False,
                 coverage=None, pt_graph=0, pt_graph_captures=0)
        monkeypatch.setattr(metrics, "_open", r)
        return r
    return fresh


def _eager(sc, cam, frame, cfg, tracer=COUNTING):
    scene, tables, pk = sc
    orig, d, px, py = camera_rays(cam, SIZE, SIZE)
    return pt.trace_paths(scene, orig, d, px, py, frame, cfg, common_origin=True,
                          tracer=tracer, tables=tables, pk=pk)


def _frames(sc, cfg, n, stand_in, record, tracer=COUNTING):
    """n orbit frames through PathGraphs and through trace_paths: outputs
    bit-equal, launches equal frame by frame -> each frame's PathGraphs
    record."""
    scene, tables, pk = sc
    graphs = pg.PathGraphs(scene, tables, pk, "cpu", tracer=tracer)
    cam = OrbitCamera(width=SIZE, height=SIZE)
    recs = []
    for f in range(n):
        cam.rotate(0.5, 0.0)
        snap = cam.snapshot()
        kernels.reset_launches()
        rec = record()
        got = graphs(snap, f, cfg, SIZE, SIZE)
        recs.append(dict(rec))
        launched = kernels.launches()
        kernels.reset_launches()
        eager_rec = record()
        want = _eager(sc, snap, f, cfg, tracer)
        assert kernels.launches() == launched, f
        for name in ("frame_idx", "lanes", "shaded_lanes", "residual"):
            assert rec[name] == eager_rec[name], (f, name)
        for name, a, b in zip(pt.PTOutput._fields, got, want):
            assert torch.equal(a, b), (f, name)
    return graphs, recs


@pytest.mark.parametrize("case", ["fits", "residual", "forest", "aniso"])
def test_replays_equal_eager(tree, forest, stand_in, record, case):
    """Four frames: the first runs uncaptured, the second
    captures, the rest replay; each bit-equal to trace_paths, with its launches and
    counters. The test scene at 1/8 overflows its budget (B'); the forest
    uncompacted is one part (U); an anisotropic material runs build_onb."""
    sc = forest if case == "forest" else tree
    frac = {"fits": 0.75, "residual": 0.125, "forest": 0.0, "aniso": 0.75}[case]
    cfg = RenderConfig(width=SIZE, height=SIZE, compact_frac=frac, compact_auto=False,
                       enable_aniso=case == "aniso")
    graphs, recs = _frames(sc, cfg, 4, stand_in, record)
    names = {"fits": {"A", "B"}, "residual": {"A", "B'"}, "forest": {"U"},
             "aniso": {"A", "B"}}[case]
    assert set(graphs.parts) == names
    assert [r["pt_graph"] for r in recs] == [0, 0, 1, 1]
    assert [r["pt_graph_captures"] for r in recs] == [0, len(names), 0, 0]
    assert all(r["residual"] == (case == "residual") for r in recs)
    n = SIZE * SIZE
    budget = pt._compact_budget(n, cfg)
    want = n if not budget else budget + (n if case == "residual" else 0)
    assert all(r["shaded_lanes"] == want and r["lanes"] == n for r in recs)


def test_launch_tally_on_replay(tree, stand_in, record):
    """A graph's launches are tallied as it is captured and added at each
    replay: launches() over replayed frames equals the eager count."""
    cfg = RenderConfig(width=SIZE, height=SIZE, compact_frac=0.75, compact_auto=False)
    graphs, _ = _frames(tree, cfg, 3, stand_in, record)
    zero = {k: 0 for k in kernels.launches()}
    assert graphs.parts["A"].tally == dict(zero, k1=1)
    assert graphs.parts["B"].tally == dict(zero, k2=2)
    kernels.reset_launches()
    cam = OrbitCamera(width=SIZE, height=SIZE).snapshot()
    for f in range(3):
        graphs(cam, 10 + f, cfg, SIZE, SIZE)
    assert kernels.launches() == dict(zero, k1=3, k2=6)


def test_both_tails_share_outputs(tree, stand_in, record):
    """One key, a budget of half the lanes: a far camera's hits fit it (B),
    a near one's overflow it (B'). B' captured after B writes into B's
    outputs, so one set is held, and every frame from either tail is
    bit-equal to trace_paths."""
    scene, tables, pk = tree
    graphs = pg.PathGraphs(scene, tables, pk, "cpu", tracer=COUNTING)
    cfg = RenderConfig(width=SIZE, height=SIZE, compact_frac=0.5, compact_auto=False)
    far = OrbitCamera(width=SIZE, height=SIZE, radius=6.0).snapshot()
    near = OrbitCamera(width=SIZE, height=SIZE, radius=2.0).snapshot()
    residual = []
    for f, cam in enumerate([far, far, far, near, near, far, near]):
        rec = record()
        got = graphs(cam, f, cfg, SIZE, SIZE)
        residual.append(rec["residual"])
        for a, b in zip(got, _eager(tree, cam, f, cfg)):
            assert torch.equal(a, b)
    assert residual == [False, False, False, True, True, False, True]
    assert set(graphs.parts) == {"A", "B", "B'"}
    for a, b in zip(graphs.parts["B"].out, graphs.parts["B'"].out):
        assert a is b


def test_bucket_change_drops_the_old_graphs(tree, stand_in, record):
    """A new key (the tuner's switch of bucket, here 3/4 -> 7/8 of the
    lanes, both holding every hit) frees the old key's outputs before
    anything of the new key runs; the new key's first frame runs
    uncaptured, and the old key's graphs are destroyed as soon as the new
    key's first capture holds the pool, before its second. One key's
    graphs are alive at a time."""
    scene, tables, pk = tree
    graphs = pg.PathGraphs(scene, tables, pk, "cpu", tracer=COUNTING)
    cam = OrbitCamera(width=SIZE, height=SIZE).snapshot()
    before = RenderConfig(width=SIZE, height=SIZE, compact_frac=0.75)
    after = RenderConfig(width=SIZE, height=SIZE, compact_frac=0.875)
    for f in range(2):
        record()
        graphs(cam, f, before, SIZE, SIZE)
    old = list(StandIn.made)
    assert len(old) == 2 and all(p.out is not None for p in old)
    seen = []

    def at_capture():
        seen.append([(p.out is None, p.destroyed) for p in old])
    StandIn.check = at_capture
    for f in range(2, 6):
        rec = record()
        got = graphs(cam, f, after, SIZE, SIZE)
        want = _eager(tree, cam, f, after)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert all(p.out is None for p in old), f
        assert rec["pt_graph"] == int(f > 3)
        assert rec["pt_graph_captures"] == (2 if f == 3 else 0)
    assert seen == [[(True, False)] * 2, [(True, True)] * 2]
    assert set(graphs.parts) == {"A", "B"} and len(StandIn.made) == 4
    assert graphs._live == list(graphs.parts.values())


def test_denoiser_settings_keep_the_graphs(tree, stand_in, record):
    """Settings that the path tracer does not read (the denoiser's, TAA,
    accumulation) keep the key: the next frame replays, bit-equal to
    trace_paths under the new config."""
    cfg = RenderConfig(width=SIZE, height=SIZE, compact_frac=0.75, compact_auto=False)
    graphs, _ = _frames(tree, cfg, 2, stand_in, record)
    cam = OrbitCamera(width=SIZE, height=SIZE).snapshot()
    for f, change in enumerate([dict(sigma_l=2.5), dict(num_atrous_iterations=3),
                                dict(accumulate=False, enable_taa=False),
                                dict(reproj_depth_threshold=1.0, sigma_n=64.0)]):
        cfg = cfg.replace(**change)
        rec = record()
        got = graphs(cam, 2 + f, cfg, SIZE, SIZE)
        assert rec["pt_graph"] == 1 and rec["pt_graph_captures"] == 0, change
        for a, b in zip(got, _eager(tree, cam, 2 + f, cfg)):
            assert torch.equal(a, b)
    assert len(StandIn.made) == 2


def test_a_key_held_one_frame_runs_eager(tree, stand_in, record):
    """A path setting that changes every frame (a depth or clamp slider
    held down) captures nothing: each key's first frame runs uncaptured.
    Once it rests, its second frame captures and the third replays."""
    scene, tables, pk = tree
    graphs = pg.PathGraphs(scene, tables, pk, "cpu", tracer=COUNTING)
    cam = OrbitCamera(width=SIZE, height=SIZE).snapshot()
    base = RenderConfig(width=SIZE, height=SIZE, compact_frac=0.75, compact_auto=False)
    clamps = [10.0, 9.0, 8.0, 7.0, 6.0, 6.0, 6.0]
    caps, replayed = [], []
    for f, c in enumerate(clamps):
        cfg = base.replace(clamp_threshold=c, max_tracing_depth=2 + f % 2 if f < 4 else 2)
        rec = record()
        got = graphs(cam, f, cfg, SIZE, SIZE)
        caps.append(rec["pt_graph_captures"])
        replayed.append(rec["pt_graph"])
        for a, b in zip(got, _eager(tree, cam, f, cfg)):
            assert torch.equal(a, b)
    assert caps == [0, 0, 0, 0, 0, 2, 0] and replayed == [0] * 6 + [1]


class _Reads:
    """A RenderConfig that records which of its fields are read."""

    def __init__(self, cfg):
        object.__setattr__(self, "_cfg", cfg)
        object.__setattr__(self, "read", set())

    def __getattr__(self, name):
        self.read.add(name)
        return getattr(self._cfg, name)


@pytest.mark.parametrize("case", ["fits", "residual", "forest", "aniso", "coherent",
                                  "separate"])
def test_path_key_holds_what_the_parts_read(tree, forest, case):
    """The path tracer's parts read no RenderConfig field outside
    path_tracer.PATH_FIELDS, so two configs with one path_key trace the
    same paths and may share graphs."""
    sc = forest if case == "forest" else tree
    frac = {"residual": 0.125, "forest": 0.0}.get(case, 0.75)
    cfg = RenderConfig(width=SIZE, height=SIZE, compact_frac=frac, compact_auto=False,
                       enable_aniso=case == "aniso", use_normal_map=True,
                       tile_coherent_sampling=case == "coherent",
                       fused_secondary=case != "separate")
    reads = _Reads(cfg)
    _eager(sc, OrbitCamera(width=SIZE, height=SIZE).snapshot(), 3, reads, tracer=pt.PLAIN)
    assert reads.read and reads.read <= set(pt.PATH_FIELDS), reads.read - set(pt.PATH_FIELDS)
    assert pt.path_key(cfg) == tuple(getattr(cfg, f) for f in pt.PATH_FIELDS)


def test_dropped_graphs_wait_for_a_safe_point(tree, stand_in, record):
    """A PathGraphs dropped with its graphs (a Renderer going out of scope,
    on any thread) frees their outputs and destroys nothing; the next frame
    of any PathGraphs destroys them under the capture lock before it runs.
    close() destroys a PathGraphs' graphs at once."""
    scene, tables, pk = tree
    cfg = RenderConfig(width=SIZE, height=SIZE, compact_frac=0.75, compact_auto=False)
    cam = OrbitCamera(width=SIZE, height=SIZE).snapshot()
    pg._RETIRED.clear()
    graphs, _ = _frames(tree, cfg, 2, stand_in, record)
    parts = list(graphs.parts.values())
    del graphs
    gc.collect()
    assert pg._RETIRED == parts
    assert all(p.out is None and not p.destroyed for p in parts)
    other = pg.PathGraphs(scene, tables, pk, "cpu", tracer=COUNTING)
    record()
    other(cam, 0, cfg, SIZE, SIZE)
    assert all(p.destroyed for p in parts) and not pg._RETIRED
    record()
    other(cam, 1, cfg, SIZE, SIZE)
    mine = list(other.parts.values())
    assert len(mine) == 2
    other.close()
    assert all(p.destroyed for p in mine) and not other.parts and not other._live
    rec = record()
    for a, b in zip(other(cam, 2, cfg, SIZE, SIZE), _eager(tree, cam, 2, cfg)):
        assert torch.equal(a, b)
    assert rec["pt_graph_captures"] == 0  # after close(), a first frame again


def test_no_capture_under_a_profiler(tree, stand_in, record):
    """A part not yet captured runs uncaptured while a torch.profiler
    session records; captured parts replay."""
    scene, tables, pk = tree
    graphs = pg.PathGraphs(scene, tables, pk, "cpu", tracer=COUNTING)
    cam = OrbitCamera(width=SIZE, height=SIZE).snapshot()
    cfg = RenderConfig(width=SIZE, height=SIZE, compact_frac=0.75, compact_auto=False)
    record()
    graphs(cam, 0, cfg, SIZE, SIZE)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        rec = record()
        got = graphs(cam, 1, cfg, SIZE, SIZE)
    assert not graphs.parts and rec["pt_graph"] == 0
    for a, b in zip(got, _eager(tree, cam, 1, cfg)):
        assert torch.equal(a, b)
    record()
    graphs(cam, 2, cfg, SIZE, SIZE)
    assert set(graphs.parts) == {"A", "B"}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        rec = record()
        graphs(cam, 3, cfg, SIZE, SIZE)
    assert rec["pt_graph"] == 1


@pytest.mark.parametrize("runner", ["eager", "graphs"])
def test_where_the_hit_count_is_read(tree, stand_in, record, monkeypatch, runner):
    """One sequence, two places for its one host read: trace_paths reads
    the hit count once the compacted pass is issued (the device shades
    while the host waits); the graphs read it before they choose B or B',
    once a frame."""
    order = []
    real_shade, real_count = pt.shade_selected, pt.host_count
    monkeypatch.setattr(pt, "shade_selected",
                        lambda *a: order.append("shade") or real_shade(*a))
    monkeypatch.setattr(pt, "host_count", lambda h: order.append("read") or real_count(h))
    scene, tables, pk = tree
    cam = OrbitCamera(width=SIZE, height=SIZE, radius=2.0).snapshot()
    cfg = RenderConfig(width=SIZE, height=SIZE, compact_frac=0.125, compact_auto=False)
    if runner == "eager":
        record()
        _eager(tree, cam, 0, cfg)
        assert order == ["shade", "read"]
        return
    graphs = pg.PathGraphs(scene, tables, pk, "cpu", tracer=COUNTING)
    for f in range(3):
        order.clear()
        rec = record()
        graphs(cam, f, cfg, SIZE, SIZE)
        assert rec["residual"]
        # the key's first frame runs as trace_paths does; later the read
        # comes first, once (the stand-in shades again at each replay)
        if f == 0:
            assert order == ["shade", "read"]
        else:
            assert order[0] == "read" and order.count("read") == 1 and "shade" in order, f
