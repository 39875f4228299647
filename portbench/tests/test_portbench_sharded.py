"""The split frame's cell on the CPU: four ranks over gloo, started by the
harness's own launcher (sharded.Ranks), at the smallest layout that
dist/frame.py:_check_layout allows with RenderConfig()'s five a-trous
steps (halo 32, 36 rows a rank), on a small scene. A planted fault runs in
a child rank: the launcher starts it from code that plants the fault,
then runs the child's own entry (sharded.CHILD)."""
from __future__ import annotations

import subprocess
import sys
import time

import pytest
import torch.distributed as dist

from portbench import control, harness, sharded, spec
from portbench.reference import config as rconfig
from portbench.spec import ROOT

CELL = "orbit800.sharded4.file20k"
SEED = 2**31 + 4321
# 4 ranks of 36 rows: halo 32 >= 2 x the largest a-trous step (16), and
# K4's reach, halo + 3, within a rank's rows
SMALL = dict(width=32, height=144, warmup_frames=1, check_frames=1)
SCENE = dict(subdiv=2, max_chunk_tris=64)  # 322 triangle rows in chunks: K6
PLANT = "import sys\nrank = int(sys.argv[sys.argv.index('--rank') + 1])\n{fault}\n" \
        "from portbench import sharded\nsys.exit(sharded.child_main())\n"


@pytest.fixture
def small(monkeypatch):
    """The cell's traffic at SMALL's size and its configuration on a small
    scene; the process group left by a failed run is destroyed."""
    traffic, config = spec.traffic, spec.config
    monkeypatch.setattr(spec, "traffic", lambda name: dict(traffic(name), **SMALL))
    monkeypatch.setattr(spec, "config", lambda name: dict(
        config(name), scene=dict(config(name)["scene"], **SCENE)))
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def plant(monkeypatch, fault: str) -> None:
    """The child ranks run `fault` (Python, with `rank` set) before their
    own entry."""
    monkeypatch.setattr(sharded, "CHILD",
                        [sys.executable, "-c", PLANT.format(fault=fault)])


def run():
    return harness.run_cell(CELL, SEED, 0.3, False, device="cpu")


def test_four_ranks_correct(small):
    result, lines = run()
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 4
    assert set(result["metrics"]) == {"frame_ms", "frame_ms_p95", "peak_mem_gib", "setup_s"}
    assert set(result["checks"]) == set(spec.limits(CELL, "orbit_sharded")["limits"])
    assert [ln.split(":")[0] for ln in lines] == [f"check {k}" for k in result["checks"]]


HALO_CLAMPED = """
import dataclasses
from tpuray_torch.dist import frame
halo_rows = frame._halo_rows
def clamped(mesh, k, *xs):
    halo_rows(mesh, k, *xs)  # the neighbours still get this rank's rows
    return halo_rows(dataclasses.replace(mesh, size=1), k, *xs)  # clamp-to-edge
if rank == 2:
    frame._halo_rows = clamped
"""
OTHER_ROWS = """
from tpuray_torch.dist import frame
shard_rays = frame.shard_rays
if rank == 2:
    frame.shard_rays = lambda cam, h, w, row0, rows: shard_rays(cam, h, w, row0 - rows, rows)
"""
STATE_UNCHANGED = """
from tpuray_torch.dist import frame
render = frame.render_frame_sharded
def stale(scene, camera, state, *a, **k):
    _, final, pt = render(scene, camera, state, *a, **k)
    return state, final, pt
if rank == 2:
    frame.render_frame_sharded = stale
"""
ANSWER_ALTERED = """
from tpuray_torch.dist import frame
render = frame.render_frame_sharded
def altered(*a, **k):
    state, final, pt = render(*a, **k)
    final = final.clone()
    final[:4] += 0.25
    return state, final, pt
if rank == 2:
    frame.render_frame_sharded = altered
"""


@pytest.mark.parametrize("fault", [HALO_CLAMPED, OTHER_ROWS, STATE_UNCHANGED, ANSWER_ALTERED],
                         ids=["halo_clamped", "other_rows", "state_unchanged",
                              "answer_altered"])
def test_rank_faults_fail(small, monkeypatch, fault):
    plant(monkeypatch, fault)
    result, _ = run()
    assert not result["correct"], result["checks"]


def test_control_fails(small):
    r = control.readings(CELL, SEED, 0.3, device="cpu")
    lim = spec.limits(CELL, "orbit_sharded")["limits"]
    assert not all(r["control"][k] <= v for k, v in lim.items()), r["control"]
    assert all(r["program"][k] <= v for k, v in lim.items()), r["program"]


EXITS_AT_ONCE = "if rank == 2:\n    sys.exit(3)"
EXITS_AFTER_A_FRAME = """
from portbench import sharded as s
def follow(shard):
    s.command(shard.mesh)
    sys.exit(3)
if rank == 2:
    s.follow = follow
"""
RUN = """
import json, sys
from portbench import harness, sharded, spec
traffic, config = spec.traffic, spec.config
spec.traffic = lambda name: dict(traffic(name), **{small})
spec.config = lambda name: dict(config(name), scene=dict(config(name)["scene"], **{scene}))
sharded.CHILD = [sys.executable, "-c", {child!r}]
result, _ = harness.run_cell({cell!r}, {seed}, 0.3, False, device="cpu")
print(json.dumps(result))
"""


@pytest.mark.parametrize("fault", [EXITS_AT_ONCE, EXITS_AFTER_A_FRAME],
                         ids=["at_once", "after_a_frame"])
def test_child_exit_ends_the_run(fault):
    code = RUN.format(small=SMALL, scene=SCENE, child=PLANT.format(fault=fault), cell=CELL,
                      seed=SEED)
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 1, out.stderr[-3000:]
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert "rank 2" in out.stderr, out.stderr[-3000:]
    assert time.monotonic() - t0 < 120


def test_reference_integrators():
    """The reference integrates NEE and MIS, and still refuses what it does
    not compute: another integrator, the tiled history read,
    fast_reproject and the program's quirks."""
    for integrator in ("nee", "mis"):
        assert rconfig.RenderConfig(integrator=integrator).integrator == integrator
    for bad in (dict(integrator="path"), dict(reproject_gather="tiled"),
                dict(fast_reproject=True), dict(reference_quirks=True)):
        with pytest.raises(NotImplementedError):
            rconfig.RenderConfig(**bad)

