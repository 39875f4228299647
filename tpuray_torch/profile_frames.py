"""Where a moving-camera frame's time goes, on the card.

    python -m tpuray_torch.profile_frames [--frames 8] [--size 800] [--out DIR]
        [--runs svgf_off,svgf_on,mis,separate,forest_131k,train_step]

Renders size x size frames, moving the camera 0.5 degrees a frame, for
each run: the chip_smoke.py test scene (20,482 triangles) with SVGF off,
with SVGF on (the default view, compaction off), under the MIS
integrator and with the separate walks (fused_secondary=False; SVGF on
for both); the 131k-triangle forest
(make_large_scene(25 spheres, subdiv 4), SVGF on, OrbitCamera radius 4);
and a train step on the test scene (chip_smoke.py phase 15: render_flat,
its MSE's backward through every material and light field, Adam on
base_color; a "frame" of this run is a step). For each: 3 warm-up frames and `--frames` synchronised frames timed on the
host clock, every run before any profiling; then `--frames` frames of each
under torch.profiler. Prints per frame the wall time, the device kernels,
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
from tpuray_torch.kernels import atrous as ka
from tpuray_torch.kernels import reproject as kr
from tpuray_torch.kernels import trace as kt
from tpuray_torch.kernels import trace_chunked as ktc
from tpuray_torch.render.renderer import Renderer
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.procedural import make_large_scene, make_test_scene
from tpuray_torch.train import optimize

# device-kernel names of the hand-written kernels (csrc/*.cu), matched as
# substrings: "trace_k1" is K1's trace_k1_warp, and older checkouts' trace_k1
_OURS = {"K1": "trace_k1", "K2": "trace_k2", "K3": "trace_k3", "K6": "trace_k6",
         "K4": "reproject_variance", "K5": "atrous_step", "K7": "gather_rows"}


def _which(name: str) -> str | None:
    """The hand-written kernel a device kernel's name belongs to (checkouts
    without trace_k3 ran K3 as trace_k1<any_hit, false>)."""
    if re.search(r"trace_k1<\w+, false>", name):
        return "K3"
    return next((k for k, v in _OURS.items() if v in name), None)


def _kernels(prof) -> list[tuple[str, float]]:
    """(name, device us) of every device kernel the profiler saw."""
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


class _Run:
    """A Renderer under one config with its moving camera."""

    def __init__(self, scene, cfg: RenderConfig, tag: str, **cam_kw):
        self.tag, self.cfg = tag, cfg
        self.r = Renderer(scene, cfg)
        self.cam = OrbitCamera(width=cfg.width, height=cfg.height, **cam_kw)

    def step(self):
        self.cam.rotate(0.5, 0.0)
        return self.r.step(self.cam.snapshot())

    def time_frames(self, frames: int) -> list[float]:
        """3 warm-up frames, then `frames` synchronised frames (ms)."""
        for _ in range(3):
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
        for m in (kt, ktc, kr, ka):
            m.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(frames):
                self.step()
            torch.cuda.synchronize()
        kernels = _kernels(prof)
        by_name = collections.defaultdict(lambda: [0, 0.0])
        for name, us in kernels:
            by_name[name][0] += 1
            by_name[name][1] += us
        wall_ms = statistics.median(wall)
        device_ms = sum(us for _, us in kernels) / 1e3 / frames
        res = dict(wall_ms=wall_ms, kernels_per_frame=len(kernels) / frames,
                   device_ms_per_frame=device_ms, busy_share=device_ms / wall_ms,
                   launches={**kt.LAUNCHES, **ktc.LAUNCHES, **kr.LAUNCHES,
                             **ka.LAUNCHES})
        tag, cfg = self.tag, self.cfg
        print(f"[{tag}] {cfg.width}x{cfg.height}: wall median {wall_ms:.3f} ms "
              f"(min {min(wall):.3f}, max {max(wall):.3f}) over {len(wall)}; "
              f"{res['kernels_per_frame']:.1f} device kernels and "
              f"{device_ms:.3f} device ms per frame; busy share "
              f"{res['busy_share']:.3f}; launches {res['launches']}", flush=True)
        ours = {k: sum(us for name, us in kernels if _which(name) == k) / 1e3 / frames
                for k in _OURS}
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


class _TrainRun(_Run):
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

    def step(self):
        self.state, loss = self.train_step(self.state, self.target, self.cam, 0)
        return loss


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--out", type=Path, default=Path("build/profile"))
    ap.add_argument("--runs", default="svgf_off,svgf_on,mis,separate,forest_131k,train_step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_frames needs a CUDA device")
    print(f"tree {Path(tpuray_torch.__file__).parents[1]}; device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    cfg = RenderConfig(width=args.size, height=args.size, compact_frac=0.0,
                       compact_auto=False)
    test = make_test_scene(subdiv=5, env_width=512, device="cuda")
    make = {
        "svgf_off": lambda: _Run(test, dataclasses.replace(cfg, enable_svgf=False), "svgf_off"),
        "svgf_on": lambda: _Run(test, cfg, "svgf_on"),
        "mis": lambda: _Run(test, dataclasses.replace(cfg, integrator="mis"), "mis"),
        "separate": lambda: _Run(test, dataclasses.replace(cfg, fused_secondary=False),
                                 "separate"),
        "forest_131k": lambda: _Run(make_large_scene(n_spheres=25, subdiv=4, env_width=512,
                                                     device="cuda"), cfg, "forest_131k",
                                    radius=4.0),
        "train_step": lambda: _TrainRun(test, cfg, "train_step"),
    }
    runs = [make[tag]() for tag in args.runs.split(",")]
    # all host-clock timing first: the profiler leaves Python objects behind
    walls = [run.time_frames(args.frames) for run in runs]
    res = {run.tag: run.profile_frames(args.frames, wall, args.out)
           for run, wall in zip(runs, walls)}
    if "svgf_off" in res and "svgf_on" in res:
        off, on = res["svgf_off"], res["svgf_on"]
        print(f"the denoiser adds {on['kernels_per_frame'] - off['kernels_per_frame']:.1f} "
              f"device kernels, {on['device_ms_per_frame'] - off['device_ms_per_frame']:.3f} "
              f"device ms and {on['wall_ms'] - off['wall_ms']:.3f} wall ms per frame",
              flush=True)


if __name__ == "__main__":
    main()
