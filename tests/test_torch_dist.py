"""The port's distribution layer (tpuray_torch/dist/sharding.py,
multihost.py, dryrun.py and train/optimize.py:make_sharded_train_step) on
the CPU, against tpuray and against the port's single-device paths.

Worlds 2 and 4 run as `python -m tpuray_torch.dist.dryrun N --check OUT
--parts tiled,train`, both at once: the command must exit 0 and print that
every rank took the same loss; rank 0 writes the gathered results. A world
of one runs in this process with no process group. Sizes: dryrun.CHECK_*
(64x64, make_test_scene(subdiv=1, env_width=32)).

- render_tiled (depth 2, frame 3) against tpuray.dist.sharding.render_tiled
  on a JAX mesh of the same size: tests/test_torch_frame.py's trace_paths
  tolerance (color rtol 2e-4 / atol 2e-5 on all but 1% of the pixels,
  albedo rtol 1e-5: XLA's FMAs move hit points by an ulp);
- the global-pixel seeds: render_tiled bit-equal at every world size and
  to the single-device row-major trace;
- the sharded SGD step's gradients within 1e-5 of the largest |gradient|
  of each field of make_train_step's (the per-rank sums and the
  all-reduce reassociate the mean), the loss within rtol 1e-6; the
  parameters after it against tpuray's make_sharded_train_step on a JAX
  mesh of the same size, within lr * 5e-3 of each field's largest
  |gradient| (tests/test_torch_train.py's tolerance; tpuray's samplers
  patched in-process as there, or clearcoat_gloss's gradient is NaN),
  every field. Every material's emissive is 0, and on a pixel whose
  light is exactly 0 (every shadow ray blocked) the final clamp
  clip(light, 0, ...) sits on its lower bound: JAX's derivative there is
  half of the one-sided one (a tie of maximum(x, 0)), and the port's
  (path_tracer.clamp_light under grad) is the same. Against this file's
  constant target those pixels carry a residual, so the emissive
  gradient is ~28% off the forward difference
  (test_tpuray_emissive_gradient_halves_at_the_clamp pins tpuray's).
  The port's sharded emissive gradient is held to tpuray's AD gradient
  within rtol 2e-2 (the two images differ on one of the 193 pixels that
  respond, by XLA's FMAs), and to the port's own forward difference with
  the tie pixels halved within rtol 1e-3 (the image is linear in
  emissive: a difference of 0.5 is exact up to rounding);
- every rank holds the same parameters after the step;
- multihost.process_rows, initialize's configuration sources (the
  process group's constructor recorded) and a real world of one over gloo.
"""
import concurrent.futures
import dataclasses
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import tpuray.scene.procedural as jproc
from tpuray.dist.sharding import make_mesh as j_make_mesh
from tpuray.dist.sharding import render_tiled as j_render_tiled
from tpuray.integrator import disney as jdisney
from tpuray.scene.camera import OrbitCamera as JOrbitCamera
from tpuray.scene.config import RenderConfig as JRenderConfig
from tpuray.train import optimize as jopt

from tpuray_torch.dist import dryrun, multihost
from tpuray_torch.dist.sharding import gather_rows, make_mesh, pad_rows, shard_span
from tpuray_torch.integrator.path_tracer import trace_paths
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.train import optimize

from tests.test_torch_train import _guarded_gtr1, _guarded_gtr2

torch.set_num_threads(2)

N = dryrun.CHECK_SIZE
WORLDS = (1, 2, 4)
PARTS = ("tiled", "train")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{world size: check_job's results}; worlds 2 and 4 through the
    dryrun command, at once."""
    d = tmp_path_factory.mktemp("dist")
    out = {n: str(d / f"w{n}.npz") for n in WORLDS}

    def command(n):
        return subprocess.run(
            [sys.executable, "-m", "tpuray_torch.dist.dryrun", str(n), "--device", "cpu",
             "--check", out[n],
             "--parts", ",".join(PARTS), "--timeout", "240"],
            capture_output=True, text=True, timeout=300, cwd=dryrun.ROOT)

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = {n: pool.submit(command, n) for n in (2, 4)}
        dryrun.check_job(make_mesh("cpu"), out[1], PARTS)
        for n, r in runs.items():
            proc = r.result()
            assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
            assert f"dryrun({n}): ok, identical loss on all processes" in proc.stdout
            assert proc.stdout.count("proc ") == n
    return {n: dict(np.load(p)) for n, p in out.items()}


@pytest.fixture(scope="module")
def jax_scene():
    """tpuray's make_test_scene; at this size both packages' native BVH
    builds are the same tree (tests/test_torch_native.py)."""
    return jproc.make_test_scene(**dryrun.CHECK_SCENE)


def _cfg(**kw):
    return dict(width=N, height=N, **dict(dryrun.CHECK_CFG, **kw))


@pytest.mark.parametrize("world", WORLDS)
def test_render_tiled_matches_tpuray(sharded, jax_scene, world):
    cam = JOrbitCamera(width=N, height=N).snapshot()
    cfg = JRenderConfig(**_cfg(max_tracing_depth=dryrun.TILED_DEPTH))
    color, emission, albedo = (np.asarray(x) for x in j_render_tiled(
        jax_scene, cam, cfg, j_make_mesh(world), N, N, frame=dryrun.TILED_FRAME))
    z = sharded[world]
    assert z["tiled_color"].shape == (N, N, 3)
    off = ~np.isclose(z["tiled_color"], color, rtol=2e-4, atol=2e-5).all(-1)
    assert off.mean() <= 0.01, f"{off.sum()} of {N * N} pixels beyond rtol 2e-4"
    np.testing.assert_allclose(z["tiled_albedo"], albedo, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(z["tiled_emission"], emission, rtol=1e-5, atol=1e-7)
    assert color.max() > 0.05


def test_render_tiled_uses_global_pixel_seeds(sharded):
    """Every world size renders the single-device image bit for bit."""
    scene = dryrun.check_scene("cpu")
    cam = OrbitCamera(width=N, height=N).snapshot()
    cfg = RenderConfig(**_cfg(max_tracing_depth=dryrun.TILED_DEPTH))
    yy, xx = torch.meshgrid(torch.arange(N), torch.arange(N), indexing="ij")
    with torch.no_grad():
        pt = trace_paths(scene, cam.eye[None], cam.ray_directions(N, N).reshape(-1, 3),
                         xx.reshape(-1), (N - 1 - yy).reshape(-1), dryrun.TILED_FRAME, cfg,
                         common_origin=True)
    for world in WORLDS:
        for name, want in (("color", pt.color), ("emission", pt.emission),
                           ("albedo", pt.albedo)):
            np.testing.assert_array_equal(sharded[world][f"tiled_{name}"],
                                          want.reshape(N, N, 3).numpy(),
                                          err_msg=f"world {world} {name}")


@pytest.fixture(scope="module")
def single_step():
    """make_train_step's SGD step on the same scene, target and camera."""
    scene = dryrun.check_scene("cpu")
    params, rebuild = optimize.split_trainable(scene, train_lights=False, device="cpu")
    init, step = optimize.make_train_step(rebuild, RenderConfig(**_cfg()), N, N,
                                          dryrun._sgd(dryrun.TRAIN_LR))
    state, loss = step(init(params), torch.full((N, N, 3), dryrun.TRAIN_TARGET),
                       OrbitCamera(width=N, height=N).snapshot(), 0)
    table = state.params["materials"]
    return float(loss), {f.name: getattr(table, f.name).grad.numpy()
                         for f in dataclasses.fields(table)}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_grads_match_single_device(sharded, single_step, world):
    loss, grads = single_step
    z = sharded[world]
    np.testing.assert_allclose(float(z["train_loss"]), loss, rtol=1e-6)
    for name, want in grads.items():
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(z[f"train_grad_{name}"], want, rtol=0,
                                   atol=1e-5 * scale + 1e-12, err_msg=name)
    assert np.abs(grads["base_color"]).max() > 0


@pytest.mark.parametrize("world", [2, 4])
def test_parameters_identical_on_every_rank(sharded, world):
    assert bool(sharded[world]["train_params_equal"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_matches_tpuray(sharded, jax_scene, world):
    """One SGD step of tpuray's make_sharded_train_step on a JAX mesh of
    the same size, from the same parameters, target and camera."""
    mesh = j_make_mesh(world)
    params, rebuild = jopt.split_trainable(jax_scene, train_lights=False)
    init, step = jopt.make_sharded_train_step(rebuild, JRenderConfig(**_cfg()), N, N,
                                              mesh, optax.sgd(dryrun.TRAIN_LR))
    target = jax.device_put(jnp.full((N, N, 3), dryrun.TRAIN_TARGET),
                            NamedSharding(mesh, P("tiles")))
    orig = jdisney.sample_gtr1, jdisney.sample_gtr2
    jdisney.sample_gtr1, jdisney.sample_gtr2 = _guarded_gtr1, _guarded_gtr2
    try:
        state, loss = step(init(params), target, JOrbitCamera(width=N, height=N).snapshot(), 0)
    finally:
        jdisney.sample_gtr1, jdisney.sample_gtr2 = orig
    z = sharded[world]
    np.testing.assert_allclose(float(z["train_loss"]), float(loss), rtol=1e-4)
    before, after = params["materials"], state.params["materials"]
    for f in dataclasses.fields(after):
        p0, p1 = np.asarray(getattr(before, f.name)), np.asarray(getattr(after, f.name))
        g_scale = float(np.abs(p0 - p1).max()) / dryrun.TRAIN_LR
        np.testing.assert_allclose(z[f"train_param_{f.name}"], p1, rtol=0,
                                   atol=dryrun.TRAIN_LR * 5e-3 * g_scale + 1e-6,
                                   err_msg=f.name)


@pytest.fixture(scope="module")
def tpuray_emissive(jax_scene):
    """tpuray's image at emissive 0 and its derivative in material 0's
    emissive (forward mode, as its backward computes it) and the
    difference of its images at emissive 0 and 1 (exact: the image is
    linear in it)."""
    cfg = JRenderConfig(**_cfg())
    cam = JOrbitCamera(width=N, height=N).snapshot()
    params, rebuild = jopt.split_trainable(jax_scene, train_lights=False)
    table = params["materials"]
    unit = jnp.zeros_like(table.emissive).at[0].set(1.0)

    def image(emissive):
        p = dict(params, materials=table.replace(emissive=emissive))
        return jopt.render_flat(rebuild(p), cam, cfg, N, N, 0)

    img0, tangent = jax.jit(lambda e: jax.jvp(image, (e,), (unit,)))(table.emissive)
    img0, tangent = np.asarray(img0), np.asarray(tangent)
    return img0, tangent, np.asarray(jax.jit(image)(unit)) - img0


def _loss_grad(img0, k):
    """d loss / d emissive[0] from the image's derivative k."""
    return (2 * (img0 - dryrun.TRAIN_TARGET) * k).sum((0, 1)) / (N * N * 3)


@pytest.mark.parametrize("world", WORLDS)
def test_emissive_gradient_is_the_forward_difference(sharded, tpuray_emissive, world):
    """d loss / d emissive of material 0 from the sharded step against
    tpuray's AD gradient, and against the forward difference of the
    single-device image with the clamp's tie halved on the pixels whose
    light is 0 (every material's emissive is 0, so only this gradient
    reads the BSDF-emissive term); material 1 (the ground) shows no such
    term at this depth."""
    img0, tangent, _ = tpuray_emissive
    scene = dryrun.check_scene("cpu")
    cfg = RenderConfig(**_cfg())
    cam = OrbitCamera(width=N, height=N).snapshot()
    images = []
    for value in (0.0, 0.5):
        e = torch.zeros_like(scene.materials.emissive)
        e[0] = value
        with torch.no_grad():
            images.append(optimize.render_flat(
                scene.replace(materials=scene.materials.replace(emissive=e)), cam, cfg, N, N, 0))
    k = ((images[1] - images[0]) / 0.5).numpy()  # d image / d emissive[0], per channel
    img = images[0].numpy()
    tie = (img == 0.0).all(-1) & (np.abs(k) > 0).any(-1)
    k[tie] *= 0.5
    got = sharded[world]["train_grad_emissive"]
    np.testing.assert_allclose(got[0], _loss_grad(img0, tangent), rtol=2e-2, atol=0)
    np.testing.assert_allclose(got[0], _loss_grad(img, k), rtol=1e-3, atol=0)
    np.testing.assert_array_equal(got[1], 0.0)
    assert tie.sum() > 0 and np.abs(got[0]).min() > 1e-5


def test_tpuray_emissive_gradient_halves_at_the_clamp(sharded, tpuray_emissive):
    """tpuray's derivative of the image in material 0's emissive against
    the difference of its images at emissive 0 and 1. On the pixels whose
    light is 0 at emissive 0, the clamp's tie halves it; everywhere else
    the two agree. The loss gradient that follows is far from the forward
    difference's, and the port's is close to the former."""
    img0, tangent, fd = tpuray_emissive
    tie = (img0 == 0.0).all(-1) & (np.abs(fd) > 0).any(-1)
    assert 0 < tie.sum() < (np.abs(fd) > 0).any(-1).sum()
    np.testing.assert_allclose(tangent[tie], 0.5 * fd[tie], rtol=1e-5, atol=0)
    np.testing.assert_allclose(tangent[~tie], fd[~tie], rtol=1e-4, atol=1e-6)

    ad, want = _loss_grad(img0, tangent), _loss_grad(img0, fd)
    assert (np.abs(ad - want) > 0.1 * np.abs(want)).all()
    np.testing.assert_allclose(sharded[1]["train_grad_emissive"][0], ad, rtol=2e-2, atol=0)


@pytest.mark.parametrize("height,world,want", [
    (64, 4, [(0, 16), (16, 32), (32, 48), (48, 64)]),
    (10, 4, [(0, 3), (3, 6), (6, 9), (9, 10)]),
    (7, 2, [(0, 4), (4, 7)]),
    (5, 1, [(0, 5)]),
])
def test_process_rows(height, world, want):
    assert [multihost.process_rows(height, world, r) for r in range(world)] == want
    assert pad_rows(height, world) == want[0][1] * world
    assert multihost.process_rows(height) == (0, height)  # alone


_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
        "TPURAY_COORDINATOR", "TPURAY_NUM_PROCESSES", "TPURAY_PROCESS_ID",
        "TPURAY_LOCAL_RANK")


@pytest.fixture
def recorded(monkeypatch):
    """initialize() with the process group's constructor recorded."""
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(dict(kw, backend=backend)))
    monkeypatch.setattr(dist, "get_world_size", lambda: calls[-1]["world_size"])
    return calls


def test_initialize_sources(recorded, monkeypatch):
    assert multihost.initialize(device="cpu") is False  # nothing configured
    assert recorded == []

    monkeypatch.setenv("TPURAY_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("TPURAY_NUM_PROCESSES", "4")
    monkeypatch.setenv("TPURAY_PROCESS_ID", "2")
    assert multihost.initialize(device="cpu") is True
    assert (recorded[-1]["init_method"], recorded[-1]["world_size"], recorded[-1]["rank"],
            recorded[-1]["backend"]) == ("tcp://10.0.0.1:1234", 4, 2, "gloo")

    # torchrun's variables come before the aliases
    for k, v in dict(MASTER_ADDR="h", MASTER_PORT="29500", WORLD_SIZE="2", RANK="1").items():
        monkeypatch.setenv(k, v)
    assert multihost.initialize(device="cpu") is True
    assert (recorded[-1]["init_method"], recorded[-1]["world_size"],
            recorded[-1]["rank"]) == ("env://", 2, 1)

    # the arguments come first; a world of one is not multi-process
    assert multihost.initialize("file:///x/store", 1, 0, device="cpu") is False
    assert (recorded[-1]["init_method"], recorded[-1]["world_size"]) == ("file:///x/store", 1)

    monkeypatch.setenv("TPURAY_COORDINATOR", "file:///y/store")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k)
    monkeypatch.delenv("TPURAY_PROCESS_ID")
    with pytest.raises(ValueError, match="incomplete"):
        multihost.initialize(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            multihost.initialize("file:///x/store", 1, 0)  # "cuda" is the default


def test_world_of_one_over_gloo(tmp_path, monkeypatch):
    """A real gloo group of one from the TPURAY_* variables: the mesh, its
    collectives and its backend check."""
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TPURAY_COORDINATOR", f"file://{tmp_path}/store")
    monkeypatch.setenv("TPURAY_NUM_PROCESSES", "1")
    monkeypatch.setenv("TPURAY_PROCESS_ID", "0")
    assert not dist.is_initialized()
    try:
        assert multihost.initialize(device="cpu") is False
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        mesh = multihost.global_mesh()
        assert (mesh.rank, mesh.size, mesh.distributed) == (0, 1, True)
        assert shard_span(10, mesh) == (0, 10)
        x = torch.arange(12.0).reshape(4, 3)
        np.testing.assert_array_equal(gather_rows(mesh, x, 3).numpy(), x[:3].numpy())
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        with pytest.raises(ValueError, match="gloo"):
            make_mesh("cpu")
    finally:
        multihost.shutdown()
    assert not dist.is_initialized()
    assert make_mesh("cpu").distributed is False


def test_dryrun_defaults_to_the_card(monkeypatch):
    """`python -m tpuray_torch.dist.dryrun N` puts its ranks on the card
    unless --device cpu is given: short of a card per rank it refuses
    before it starts any."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dryrun.subprocess, "Popen", None)  # no rank may start
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main(["2"])
    with pytest.raises(RuntimeError, match="2 CUDA devices"):
        dryrun.launch(2)
