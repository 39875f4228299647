"""Where a moving-camera frame's time goes, on the card.

    python -m tpuray_torch.profile_frames [--frames 8] [--size 800] [--out DIR]
        [--runs svgf_off,svgf_on,mis,separate,forest_131k,train_step,sharded,
                file_20k,file_20k_off,file_5k,file_5k_off]

Renders size x size frames, moving the camera 0.5 degrees a frame, for
each run: the chip_smoke.py test scene (20,482 triangles) with SVGF off,
with SVGF on (the default view, compaction off), under the MIS
integrator and with the separate walks (fused_secondary=False; SVGF on
for both); the 131k-triangle forest
(make_large_scene(25 spheres, subdiv 4), SVGF on, OrbitCamera radius 4);
and a train step on the test scene (chip_smoke.py phase 15: render_flat,
its MSE's backward through every material and light field, Adam on
base_color; a "frame" of this run is a step); the svgf_on frames through
dist/frame.py:render_frame_sharded on a world of one (sharded: K4 and K5,
as svgf_on; a world of one holds the whole image and exchanges no halo);
and the test scene loaded
from an OBJ file by build_scene (file_scene: textured, the -1 material
sentinels, 4 point lights) under the default RenderConfig, compaction and
its budget buckets on, and with compaction off (_off): at subdiv 5 (20,482
triangles, a chunked forest by the layout rule: K6) and at subdiv 4 (5,122,
a single tree: K1 and K2). For each: 3 warm-up frames (24 under
compact_auto, past the first budget switch after frame 16) and `--frames`
synchronised frames timed on the host clock, every run before any
profiling; then `--frames` frames of each
under torch.profiler, after SESSION_PAD padding kernels (the profiler
loses the first kernels of a session; `profiled`). Prints per frame the
wall time, the device kernels,
their summed device time, the device's busy share (device time over the
unprofiled wall time), each hand-written kernel's share of the device time
and its device ms per frame, and the kernels that take the most device
time. What SVGF on adds over
SVGF off is the denoiser's share. The profiler's tables go to DIR
(default build/profile, which git ignores). --runs picks the runs
(default: all). Another checkout's kernels go through the same runs with
`PYTHONPATH=DIR python3 tpuray_torch/profile_frames.py` (DIR unpacked with
`git archive`; its hand-written kernels are named as its build names
them). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import re
import statistics
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

import tpuray_torch
from tpuray_torch.dist.frame import render_frame_sharded, shard_state
from tpuray_torch.dist.sharding import make_mesh
from tpuray_torch.integrator.gather_tables import pack_scene_tables
from tpuray_torch.integrator.path_tracer import pack_traversal
from tpuray_torch.kernels import launches, reset_launches
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.render.renderer import Renderer
from tpuray_torch.scene import builder
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.procedural import (
    make_large_scene, make_test_scene, write_test_scene_obj)
from tpuray_torch.train import optimize

# device-kernel names of the hand-written kernels (csrc/*.cu), matched as
# substrings: "trace_k1" is K1's trace_k1_warp, and older checkouts' trace_k1
_OURS = {"K1": "trace_k1", "K2": "trace_k2", "K3": "trace_k3", "K6": "trace_k6",
         "K4": "reproject_variance", "K5": "atrous_step", "K7": "gather_rows",
         "TAA": "taa_kernel"}


def _which(name: str) -> str | None:
    """The hand-written kernel a device kernel's name belongs to (checkouts
    without trace_k3 ran K3 as trace_k1<any_hit, false>)."""
    if re.search(r"trace_k1<\w+, false>", name):
        return "K3"
    return next((k for k, v in _OURS.items() if v in name), None)


# file_scene's scale: the sphere and ground cover ~10% of the default view
# (the original renderer's clock covers ~8% of its startup view)
FILE_SCENE_SCALE = (2.0, 2.0, 2.0)


def file_scene(subdiv: int, device="cuda", obj_dir: Path = Path("build")):
    """make_test_scene's geometry written as an OBJ with non-constant
    texture coordinates under obj_dir, loaded by build_scene with procedural
    texture layers, the -1 material sentinels and the 4 point lights of
    reference_default_scene."""
    obj_dir.mkdir(parents=True, exist_ok=True)
    path = str(obj_dir / f"test_scene_{subdiv}.obj")
    write_test_scene_obj(path, subdiv)
    spec = builder.ObjectSpec(path=path, material=dict(builder.DEFAULT_MATERIAL),
                              scale=FILE_SCENE_SCALE)
    return builder.build_scene([spec], point_lights=builder.DEFAULT_LIGHTS,
                               with_textures=True, device=device)


# torch.profiler (Kineto over CUPTI) loses the first kernel records, in
# launch order, of most sessions, the more the older the process: on an
# H100, of a test session of 30 kernels, none 38 s into chip_smoke.py's
# run, the first 14 at 213 s, 21 at 300 s, all 30 at 468 s, where one
# session also lost 533 padding kernels and the next lost none (PERF.md
# §7). The hand-written kernels are no special case: they were first in
# line. So a session (profiled) first launches SESSION_PAD one-cycle spin
# kernels, and one that lost a kernel past them is run again.
SESSION_PAD = 512
SESSION_ATTEMPTS = 5


def pad_session() -> None:
    """The kernels a session may lose: SESSION_PAD one-cycle spins."""
    for _ in range(SESSION_PAD):
        torch.cuda._sleep(1)


def lost_launches(prof) -> list[int]:
    """The positions, in launch order, of the session's kernel launches
    that have no kernel record (the runtime's launch call and the kernel
    share a correlation id)."""
    raw = prof.profiler.kineto_results.events()
    recorded = {e.correlation_id() for e in raw
                if e.device_type() == torch.autograd.DeviceType.CUDA}
    launched = sorted((e for e in raw if "LaunchKernel" in e.name()),
                      key=lambda e: e.start_ns())
    return [i for i, e in enumerate(launched) if e.correlation_id() not in recorded]


def profiled(fn) -> tuple[profile, list[tuple[str, float]], int, int]:
    """fn() under torch.profiler after pad_session, in a new session again
    while the profiler lost a kernel past the padding (at most
    SESSION_ATTEMPTS sessions) -> (the profile, (name, device us) of its
    device events but the spins, the padding kernels it lost, the sessions
    it took)."""
    for attempt in range(1, SESSION_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pad_session()
            fn()
            torch.cuda.synchronize()
        lost = lost_launches(prof)
        if not lost or lost[-1] < SESSION_PAD:
            return prof, [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and "spin_kernel" not in e.name], len(lost), attempt
    raise RuntimeError(f"torch.profiler lost kernels past the {SESSION_PAD} padding kernels "
                       f"in {SESSION_ATTEMPTS} sessions running")


class FrameRun:
    """A Renderer under one config with its moving camera."""

    def __init__(self, scene, cfg: RenderConfig, tag: str, **cam_kw):
        self.tag, self.cfg = tag, cfg
        self.r = Renderer(scene, cfg)
        self.cam = OrbitCamera(width=cfg.width, height=cfg.height, **cam_kw)
        # past the first budget switch (after 2 * Renderer._TUNE_EVERY frames)
        self.warmup = 3 * Renderer._TUNE_EVERY if cfg.compact_auto else 3

    def step(self):
        self.cam.rotate(0.5, 0.0)
        return self.r.step(self.cam.snapshot())

    def current_cfg(self) -> RenderConfig:
        """The config of the next frame (its compaction bucket)."""
        return self.r.frame_cfg

    def time_frames(self, frames: int) -> list[float]:
        """The warm-up frames, then `frames` synchronised frames (ms)."""
        for _ in range(self.warmup):
            self.step()
        torch.cuda.synchronize()
        wall = []
        for _ in range(frames):
            t0 = time.perf_counter()
            self.step()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        return wall

    def profile_frames(self, frames: int, wall: list[float], out_dir: Path) -> dict:
        def run():
            reset_launches()
            for _ in range(frames):
                self.step()

        prof, kernels, dropped, sessions = profiled(run)
        by_name = collections.defaultdict(lambda: [0, 0.0])
        for name, us in kernels:
            by_name[name][0] += 1
            by_name[name][1] += us
        wall_ms = statistics.median(wall)
        device_ms = sum(us for _, us in kernels) / 1e3 / frames
        res = dict(wall_ms=wall_ms, kernels_per_frame=len(kernels) / frames,
                   device_ms_per_frame=device_ms, busy_share=device_ms / wall_ms,
                   launches=launches(), dropped=dropped, sessions=sessions)
        tag, cfg = self.tag, self.current_cfg()
        print(f"[{tag}] {cfg.width}x{cfg.height}, compact_frac {cfg.compact_frac}: wall median {wall_ms:.3f} ms "
              f"(min {min(wall):.3f}, max {max(wall):.3f}) over {len(wall)}; "
              f"{res['kernels_per_frame']:.1f} device kernels and "
              f"{device_ms:.3f} device ms per frame; busy share "
              f"{res['busy_share']:.3f}; launches {res['launches']}; padding kernels the "
              f"profiler lost {dropped}, sessions {sessions}", flush=True)
        ours = {k: sum(us for name, us in kernels if _which(name) == k) / 1e3 / frames
                for k in _OURS}
        # the hand-written kernels' device events, to hold against the launches
        res["events"] = {k: sum(1 for name, _ in kernels if _which(name) == k) for k in _OURS}
        res["ours_ms"] = ours
        print(f"[{tag}]   share of device time (device ms per frame): "
              + ", ".join(f"{k} {ms / device_ms:.3f} ({ms:.4f})" for k, ms in ours.items() if ms),
              flush=True)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
        for name, (n, us) in top:
            print(f"[{tag}]   {us / 1e3 / frames:8.3f} ms/frame {n / frames:7.1f} "
                  f"launches/frame  {name[:110]}", flush=True)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{tag}.txt").write_text(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))
        return res


class ShardedRun(FrameRun):
    """dist/frame.py:render_frame_sharded on `mesh` under one config with
    its moving camera (every frame moving: the static branch is the
    caller's choice there)."""

    def __init__(self, scene, cfg: RenderConfig, tag: str, mesh, halo: int = 32,
                 **cam_kw):
        self.tag, self.cfg, self.mesh, self.halo = tag, cfg, mesh, halo
        self.scene = scene.to(mesh.device)
        with torch.no_grad():
            self.tables = pack_traversal(self.scene)
            self.pk = pack_scene_tables(self.scene)
        self.state = shard_state(FrameState.initial(cfg.height, cfg.width), mesh)
        self.cam = OrbitCamera(width=cfg.width, height=cfg.height, **cam_kw)
        self.warmup = 3

    def current_cfg(self) -> RenderConfig:
        return self.cfg

    @torch.no_grad()
    def step(self):
        self.cam.rotate(0.5, 0.0)
        self.state, final, _ = render_frame_sharded(
            self.scene, self.cam.snapshot(), self.state, self.cfg, self.cfg.height,
            self.cfg.width, self.mesh, halo=self.halo, tables=self.tables, pk=self.pk)
        return final


class _TrainRun(FrameRun):
    """make_train_step's step from base_color * 0.4 + 0.3 toward the
    scene's own render (cli/main.py:cmd_train's recovery)."""

    def __init__(self, scene, cfg: RenderConfig, tag: str):
        self.tag, self.cfg = tag, cfg
        h, w = cfg.height, cfg.width
        params, rebuild = optimize.split_trainable(scene)
        self.cam = OrbitCamera(width=w, height=h).snapshot("cuda")
        with torch.no_grad():
            self.target = optimize.render_flat(rebuild(params), self.cam, cfg, h, w, 0)
            params["materials"].base_color.mul_(0.4).add_(0.3)
        init, self.train_step = optimize.make_train_step(
            rebuild, cfg, h, w,
            lambda _: torch.optim.Adam([params["materials"].base_color], lr=1e-2))
        self.state = init(params)
        self.warmup = 3

    def current_cfg(self) -> RenderConfig:
        return self.cfg

    def step(self):
        self.state, loss = self.train_step(self.state, self.target, self.cam, 0)
        return loss


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--out", type=Path, default=Path("build/profile"))
    ap.add_argument("--runs", default="svgf_off,svgf_on,mis,separate,forest_131k,train_step,"
                    "sharded,file_20k,file_20k_off,file_5k,file_5k_off")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_frames needs a CUDA device")
    print(f"tree {Path(tpuray_torch.__file__).parents[1]}; device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    cfg = RenderConfig(width=args.size, height=args.size, compact_frac=0.0,
                       compact_auto=False)
    test = make_test_scene(subdiv=5, env_width=512, device="cuda")
    default = RenderConfig(width=args.size, height=args.size)
    files = {}

    def file_run(subdiv, tag, run_cfg):
        if subdiv not in files:
            files[subdiv] = file_scene(subdiv)
        return FrameRun(files[subdiv], run_cfg, tag)

    make = {
        "svgf_off": lambda: FrameRun(test, dataclasses.replace(cfg, enable_svgf=False),
                                     "svgf_off"),
        "svgf_on": lambda: FrameRun(test, cfg, "svgf_on"),
        "mis": lambda: FrameRun(test, dataclasses.replace(cfg, integrator="mis"), "mis"),
        "separate": lambda: FrameRun(test, dataclasses.replace(cfg, fused_secondary=False),
                                     "separate"),
        "forest_131k": lambda: FrameRun(make_large_scene(n_spheres=25, subdiv=4,
                                                         env_width=512, device="cuda"),
                                        cfg, "forest_131k", radius=4.0),
        "train_step": lambda: _TrainRun(test, cfg, "train_step"),
        "sharded": lambda: ShardedRun(test, cfg, "sharded", make_mesh("cuda")),
        "file_20k": lambda: file_run(5, "file_20k", default),
        "file_20k_off": lambda: file_run(5, "file_20k_off", cfg),
        "file_5k": lambda: file_run(4, "file_5k", default),
        "file_5k_off": lambda: file_run(4, "file_5k_off", cfg),
    }
    runs = [make[tag]() for tag in args.runs.split(",")]
    # all host-clock timing first: the profiler leaves Python objects behind
    walls = [run.time_frames(args.frames) for run in runs]
    res = {run.tag: run.profile_frames(args.frames, wall, args.out)
           for run, wall in zip(runs, walls)}
    for tag in ("file_20k", "file_5k"):
        if tag in res and tag + "_off" in res:
            on, off = res[tag], res[tag + "_off"]
            print(f"[{tag}] compaction saves {off['device_ms_per_frame'] - on['device_ms_per_frame']:.3f} "
                  f"device ms, {off['kernels_per_frame'] - on['kernels_per_frame']:.1f} device "
                  f"kernels and {off['wall_ms'] - on['wall_ms']:.3f} wall ms per frame", flush=True)
    if "svgf_off" in res and "svgf_on" in res:
        off, on = res["svgf_off"], res["svgf_on"]
        print(f"the denoiser adds {on['kernels_per_frame'] - off['kernels_per_frame']:.1f} "
              f"device kernels, {on['device_ms_per_frame'] - off['device_ms_per_frame']:.3f} "
              f"device ms and {on['wall_ms'] - off['wall_ms']:.3f} wall ms per frame",
              flush=True)


if __name__ == "__main__":
    main()
