"""Multi-process dry run: N OS processes, one rank each, over
torch.distributed (the port's counterpart of scripts/dryrun_multiprocess.py
and of __graft_entry__.py:dryrun_multichip).

    python -m tpuray_torch.dist.dryrun N [--device cuda|cpu] [--check OUT.npz]

starts N ranks of this module through multihost.initialize (the TPURAY_*
variables, a file store in a fresh temporary directory), each with one
torch thread. Every rank takes one row-sharded train step (Adam, the
gradients all-reduced) and renders one fully sharded frame; each prints
its loss, the parent asserts that the losses are identical and the ranks
check that their parameters are. --check also runs `check_job` and has
rank 0 write its results to OUT.npz (the tests compare them with tpuray
and with the port's single-device paths). A rank that outlives --timeout
is killed with its whole process group. The ranks run on the card (NCCL,
a card per rank) unless --device cpu asks for the CPU (gloo).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]

# check_job's sizes: tests/test_dist_frame.py's frame, cut to one bounce
CHECK_SIZE = 64
CHECK_SCENE = dict(subdiv=1, env_width=32)
CHECK_CFG = dict(max_tracing_depth=1, num_atrous_iterations=2, compact_frac=0.0,
                 compact_auto=False)
CHECK_HALO = 8
CHECK_ROTATIONS = (0.0, 1.5)  # degrees of yaw before each moving frame
CHECK_COMPACT = 0.5           # the compacted frames' budget
TILED_FRAME, TILED_DEPTH = 3, 2  # render_tiled's frame index and depth
TRAIN_LR = 0.1                # check_job's SGD step
TRAIN_TARGET = 0.3


def _sgd(lr):
    return lambda leaves: torch.optim.SGD(leaves, lr=lr)


def _flat_params(params) -> torch.Tensor:
    from tpuray_torch.train.optimize import parameters
    return torch.cat([p.detach().reshape(-1) for p in parameters(params)])


def _same_on_every_rank(mesh, x: torch.Tensor) -> bool:
    """True iff every rank holds x bit for bit."""
    from tpuray_torch.dist.sharding import gather_rows
    everyone = gather_rows(mesh, x.reshape(1, -1))
    return bool((everyone == everyone[:1]).all())


def check_scene(device):
    from tpuray_torch.scene.procedural import make_test_scene
    return make_test_scene(**CHECK_SCENE, device=device)


def frames_sharded(scene, cfg, mesh, rotations, halo, static_last=False):
    """Moving frames of render_frame_sharded from the initial state ->
    ([full final per frame], [full pt_color per frame], full last state).
    static_last: the last frame repeats the camera as a still frame."""
    from tpuray_torch.dist.frame import gather_state, render_frame_sharded, shard_state
    from tpuray_torch.dist.sharding import gather_rows
    from tpuray_torch.integrator.gather_tables import pack_scene_tables
    from tpuray_torch.integrator.path_tracer import pack_traversal
    from tpuray_torch.render.frame_state import FrameState
    from tpuray_torch.scene.camera import OrbitCamera

    h, w = cfg.height, cfg.width
    tables, pk = pack_traversal(scene), pack_scene_tables(scene)
    cam = OrbitCamera(width=w, height=h)
    state = shard_state(FrameState.initial(h, w), mesh)
    finals, pts = [], []
    for i, rot in enumerate(rotations):
        still = static_last and i == len(rotations) - 1
        cam.rotate(0.0 if still else rot, 0.0)
        state, final, pt_color = render_frame_sharded(
            scene, cam.snapshot(), state, cfg, h, w, mesh, halo=halo,
            static_camera=still, tables=tables, pk=pk)
        finals.append(gather_rows(mesh, final))
        pts.append(gather_rows(mesh, pt_color))
    return finals, pts, gather_state(state, mesh)


CHECK_PARTS = ("tiled", "frames", "tiled_read", "train")
# the denoisers of the "frames" part: the key prefix -> cfg.pallas_denoise
DENOISERS = {"kernels": True, "plain": False}


def check_job(mesh, out: str | None, parts=CHECK_PARTS) -> None:
    """The comparisons the tests make, at CHECK_SIZE: render_tiled
    ("tiled"), moving, still and compacted sharded frames under each of
    DENOISERS, its keys prefixed with the denoiser's ("frames"), the moving
    frames under reproject_gather="tiled", prefixed with the denoiser's and
    "tiled_read" ("tiled_read"), and one
    sharded SGD step ("train": loss, gradients, parameters, and whether
    every rank holds the same parameters). Rank 0 writes them to `out`."""
    from tpuray_torch.dist.sharding import gather_rows, render_tiled
    from tpuray_torch.scene.camera import OrbitCamera
    from tpuray_torch.scene.config import RenderConfig

    dev = mesh.device
    n = CHECK_SIZE
    scene = check_scene(dev)
    cfg = RenderConfig(width=n, height=n, **CHECK_CFG)
    res = {}

    cam = OrbitCamera(width=n, height=n).snapshot(dev)
    if "tiled" in parts:
        tiled = render_tiled(scene, cam, dataclasses.replace(cfg, max_tracing_depth=TILED_DEPTH),
                             mesh, n, n, frame=TILED_FRAME)
        for name, x in zip(("color", "emission", "albedo"), tiled):
            res[f"tiled_{name}"] = gather_rows(mesh, x, n)

    for den, pallas in DENOISERS.items() if "frames" in parts else ():
        dcfg = dataclasses.replace(cfg, pallas_denoise=pallas)
        with torch.no_grad():
            finals, pts, state = frames_sharded(scene, dcfg, mesh, CHECK_ROTATIONS, CHECK_HALO)
            for i, (f, p) in enumerate(zip(finals, pts)):
                res[f"{den}_moving_final_{i}"], res[f"{den}_moving_pt_{i}"] = f, p
            for field in ("history_len", "illum_hist", "moments", "taa_color"):
                res[f"{den}_moving_state_{field}"] = getattr(state, field)
            finals, _, _ = frames_sharded(scene, dcfg, mesh, (0.0, 0.0), CHECK_HALO,
                                          static_last=True)
            res[f"{den}_static_final_1"] = finals[1]
            finals, _, _ = frames_sharded(
                scene, dataclasses.replace(dcfg, compact_frac=CHECK_COMPACT), mesh,
                CHECK_ROTATIONS, CHECK_HALO)
            for i, f in enumerate(finals):
                res[f"{den}_compact_final_{i}"] = f

    for den, pallas in DENOISERS.items() if "tiled_read" in parts else ():
        dcfg = dataclasses.replace(cfg, pallas_denoise=pallas, reproject_gather="tiled")
        with torch.no_grad():
            finals, _, state = frames_sharded(scene, dcfg, mesh, CHECK_ROTATIONS, CHECK_HALO)
        for i, f in enumerate(finals):
            res[f"{den}_tiled_read_moving_final_{i}"] = f
        res[f"{den}_tiled_read_moving_state_history_len"] = state.history_len

    if "train" in parts:
        _check_train(mesh, scene, cfg, cam, res)
    if mesh.rank == 0 and out:
        np.savez(out, world=mesh.size,
                 **{k: v.detach().cpu().numpy() for k, v in res.items()})


def _check_train(mesh, scene, cfg, cam, res: dict) -> None:
    from tpuray_torch.train import optimize

    dev, n = mesh.device, CHECK_SIZE
    params, rebuild = optimize.split_trainable(scene, train_lights=False, device=dev)
    init, step = optimize.make_sharded_train_step(rebuild, cfg, n, n, mesh,
                                                  optimizer=_sgd(TRAIN_LR))
    lo = mesh.rank * (n // mesh.size)
    target = torch.full((n, n, 3), TRAIN_TARGET, device=dev)[lo:lo + n // mesh.size]
    state, loss = step(init(params), target, cam, 0)
    res["train_loss"] = loss
    for table in state.params.values():
        for f in dataclasses.fields(table):
            leaf = getattr(table, f.name)
            res[f"train_grad_{f.name}"] = leaf.grad
            res[f"train_param_{f.name}"] = leaf.detach()
    res["train_params_equal"] = torch.tensor(
        _same_on_every_rank(mesh, _flat_params(state.params)))


def dryrun_step(mesh) -> tuple[float, float]:
    """__graft_entry__.py:dryrun_multichip's work on this rank: one sharded
    Adam step on rows 16 a rank wide, then one fully sharded frame ->
    (loss, the frame's mean). Asserts a finite loss that moved the
    parameters, the same parameters on every rank, and a finite frame."""
    from tpuray_torch.dist.frame import render_frame_sharded, shard_state
    from tpuray_torch.dist.sharding import gather_rows
    from tpuray_torch.render.frame_state import FrameState
    from tpuray_torch.scene.camera import OrbitCamera
    from tpuray_torch.scene.config import RenderConfig
    from tpuray_torch.train import optimize

    dev = mesh.device
    h, w = 16 * mesh.size, 16  # 16 rows a rank: the largest a-trous halo (9) fits
    scene = check_scene(dev)
    cfg = RenderConfig(width=w, height=h, max_tracing_depth=2, num_atrous_iterations=3)
    cam = OrbitCamera(width=w, height=h).snapshot(dev)
    params, rebuild = optimize.split_trainable(scene, device=dev)
    before = _flat_params(params).clone()
    init, step = optimize.make_sharded_train_step(rebuild, cfg, h, w, mesh)
    target = torch.full((h // mesh.size, w, 3), 0.25, device=dev)
    state, loss = step(init(params), target, cam, 0)
    loss = float(loss)
    after = _flat_params(state.params)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if torch.equal(before, after):
        raise RuntimeError("the train step moved no parameter")
    if not _same_on_every_rank(mesh, after):
        raise RuntimeError("the ranks hold different parameters")

    fstate = shard_state(FrameState.initial(h, w), mesh)
    with torch.no_grad():
        fstate, final, _ = render_frame_sharded(scene, cam, fstate, cfg, h, w, mesh, halo=8)
    full = gather_rows(mesh, final)
    if not bool(torch.isfinite(full).all()):
        raise RuntimeError("non-finite sharded frame")
    return loss, float(full.mean())


def worker(device: str, check: str | None, parts=CHECK_PARTS) -> None:
    from tpuray_torch.dist import multihost

    torch.set_num_threads(1)
    multihost.initialize(device=device)
    try:
        mesh = multihost.global_mesh()
        loss, mean = dryrun_step(mesh)
        lo, hi = multihost.process_rows(16 * mesh.size)
        print(f"proc {mesh.rank}/{mesh.size}: loss={loss:.9f} rows=[{lo},{hi}) "
              f"frame mean={mean:.6f}", flush=True)
        if check:
            check_job(mesh, check, parts)
    finally:
        multihost.shutdown()


def launch(n: int, device: str = "cuda", check: str | None = None,
           parts=CHECK_PARTS, timeout: float = 300.0) -> list[str]:
    """Run n ranks of this module's worker -> each rank's output. Raises
    if a rank fails, if the losses differ, or at the timeout (every rank's
    process group killed first)."""
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun: {n} ranks on the card need {n} CUDA devices, found "
                           f"{torch.cuda.device_count()}; pass --device cpu (device='cpu') "
                           "to run them on the CPU over gloo")
    store = tempfile.mkdtemp(prefix="tpuray_dist_")
    env = dict(os.environ, TPURAY_COORDINATOR=f"file://{store}/store",
               TPURAY_NUM_PROCESSES=str(n), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "tpuray_torch.dist.dryrun", "--worker", "--device", device]
    if check:
        cmd += ["--check", check, "--parts", ",".join(parts)]
    procs = [subprocess.Popen(cmd, env=dict(env, TPURAY_PROCESS_ID=str(i),
                                            TPURAY_LOCAL_RANK=str(i)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              start_new_session=True, cwd=ROOT)
             for i in range(n)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                        .decode(errors="replace"))
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"dryrun: the ranks did not finish in {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()
        shutil.rmtree(store, ignore_errors=True)
    if any(p.returncode for p in procs):
        raise RuntimeError("dryrun: a rank failed:\n" + "\n".join(o[-3000:] for o in outs))
    losses = {line.split("loss=")[1].split()[0] for o in outs
              for line in o.splitlines() if line.startswith("proc ")}
    if len(losses) != 1:
        raise AssertionError(f"dryrun: the loss differs across ranks: {losses}")
    return outs


def dryrun_multichip(n: int, device: str = "cuda", check: str | None = None,
                     parts=CHECK_PARTS, timeout: float = 300.0) -> None:
    """One sharded train step and one sharded frame on n ranks (n OS
    processes): the port's __graft_entry__.py:dryrun_multichip. Prints
    every rank's output, then the verdict."""
    for o in launch(n, device, check, parts, timeout):
        print(o, end="")
    print(f"dryrun({n}): ok, identical loss on all processes", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tpuray_torch.dist.dryrun")
    p.add_argument("n", type=int, nargs="?", default=2, help="number of ranks")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--check", default=None, metavar="OUT.npz")
    p.add_argument("--parts", default=",".join(CHECK_PARTS),
                   help="the parts of check_job to run")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        worker(args.device, args.check, args.parts.split(","))
        return 0
    dryrun_multichip(args.n, args.device, args.check, args.parts.split(","), args.timeout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
