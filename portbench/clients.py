"""The closed-loop clients of the traffic kinds. One user: each frame
or step is issued after the one before has completed on the device.

- "orbit": a Renderer (tpuray_torch.render.renderer.Renderer.step) on an
  orbit camera that turns traffic["yaw_step_deg"] a frame from a starting
  yaw drawn from the seed; a frame ends when its final image is ready.
- "train": the step of tpuray_torch.train.optimize.make_train_step with
  the CLI's `train` recipe (the target rendered at frame 0, every
  material's base_color set to x * 0.4 + 0.3, Adam on every material and
  light leaf), a fixed camera at the seed's yaw; a step ends when the
  optimizer's update is done.
- "orbit_sharded" (sharded.py): the orbit, each frame split by rows over
  traffic["ranks"] processes, one card each; a frame ends when rank 0
  holds the full final image.

Each client takes its inputs from the harness (scenes.py) and hands the
check (check.py) what the timed path produced, copied to host memory as
soon as it is made; the seconds of copying are left out of the window's
clock (timed() returns them).
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from portbench import check, scenes
from portbench.reference import camera as rcam
from portbench.reference import config as rconfig
from portbench.reference.host import material_table_arrays
from portbench.reference.shade import MATERIAL_FIELDS
from portbench.sharded import OrbitSharded


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def ref_cfg(cfg) -> rconfig.RenderConfig:
    """The reference's config with the program's values."""
    return rconfig.RenderConfig(**{k: getattr(cfg, k) for k in
                                   rconfig.RenderConfig.__dataclass_fields__})


class Orbit:
    unit = "frame"
    rate_metric, tail_metric = "frame_ms", "frame_ms_p95"

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        from tpuray_torch.render.renderer import Renderer
        from tpuray_torch.scene.config import RenderConfig
        self.conf, self.traffic, self.device = conf, traffic, device
        self.cfg = RenderConfig(width=traffic["width"], height=traffic["height"],
                                **conf.get("render", {}))
        self.made = scenes.inputs(conf)
        scene, self.scene_build_s = scenes.program_scene(conf, self.made, device)
        self.renderer = Renderer(scene, self.cfg, device=device)
        rnd = random.Random(seed)
        self.yaw0 = rnd.uniform(0.0, 360.0)
        self.pick = random.Random(seed ^ 0x5EED)
        self.n = 0

    def camera(self, i: int) -> dict:
        cam = self.conf["camera"]
        return rcam.orbit_camera(self.yaw0 + i * self.traffic["yaw_step_deg"],
                                 cam["pitch_deg"], cam["radius"], self.cfg.width,
                                 self.cfg.height, cam["fov_y_deg"])

    def frame(self):
        """One frame -> (its camera's arrays, the program's FrameOutputs)."""
        from tpuray_torch.scene.types import Camera
        arrays = self.camera(self.n)
        cam = Camera(**{k: torch.as_tensor(v) for k, v in arrays.items()})
        out = self.renderer.step(cam)
        self.n += 1
        return arrays, out

    def kept_frame(self) -> tuple[dict, float]:
        """One frame kept for the check -> (its record, the seconds spent
        copying it). The record is a copy in host memory, made as soon as
        each part exists: the state before the frame (before the frame
        runs, since a program may update its buffers in place), then its
        outputs and the state after. So the check never reads the
        program's device buffers, and the memory peak holds none of it."""
        t = time.perf_counter()
        before = check.host_state(self.renderer.state)
        paused = time.perf_counter() - t
        arrays, out = self.frame()
        sync(self.device)
        t = time.perf_counter()
        rec = dict(state=before, camera=arrays, out=check.host_outputs(out),
                   next=check.host_state(self.renderer.state), coverage=float(out.coverage))
        return rec, paused + time.perf_counter() - t

    def warm_up(self) -> None:
        """Frame 0 (kept for the check) and the rest of the warm-up: past the
        first compaction-budget switch."""
        self.first, _ = self.kept_frame()
        for _ in range(self.traffic["warmup_frames"] - 1):
            self.frame()
        sync(self.device)
        self.kept: list[dict] = []
        self.seen = 0

    def timed(self) -> float:
        """A window unit -> the seconds spent keeping it for the check,
        which the window's clock leaves out. A sample of the window's
        frames drawn from the seed (reservoir sampling, decided before each
        frame runs) is kept."""
        k = self.traffic["check_frames"]
        slot = len(self.kept) if len(self.kept) < k else self.pick.randrange(self.seen + 1)
        self.seen += 1
        if slot >= k:
            self.frame()
            sync(self.device)
            return 0.0
        rec, paused = self.kept_frame()
        if slot == len(self.kept):
            self.kept.append(rec)
        else:
            self.kept[slot] = rec
        return paused

    def untimed(self) -> dict:
        """A frame outside the window (the traced ones) -> what its roofline
        counts read."""
        out = self.frame()[1]
        return dict(linear_z=out.gbuffer.linear_z, history_len=out.svgf.history_len)

    @staticmethod
    def counts(rec: dict) -> dict:
        """A traced frame's pixels, non-sky pixels, and K4's failed and
        fallback pixels."""
        non_sky = rec["linear_z"] != 1.0
        hl = rec["history_len"]
        return dict(pixels=int(non_sky.numel()), non_sky=int(non_sky.sum()),
                    k4_failed=int(((hl == 1) & non_sky).sum()),
                    k4_fallback=int(((hl < 4) & non_sky).sum()))

    def scene_context(self) -> dict:
        """The triangle rows the program holds and the share of frame 0's
        primary rays that hit geometry."""
        return dict(triangle_rows=int(self.renderer.scene.triangles.count),
                    primary_hit_share=self.first["coverage"])

    def check_inputs(self) -> list[dict]:
        """The kept frames' records, in host memory: frame 0 first."""
        return [self.first] + self.kept

    def release(self) -> None:
        """Drop the program's state."""
        self.renderer = None


class Train:
    unit = "step"
    rate_metric, tail_metric = "train_step_ms", "train_step_ms_p95"
    CHECKED_STEPS = 3

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        from tpuray_torch.scene.config import RenderConfig
        from tpuray_torch.scene.types import Camera
        from tpuray_torch.train import optimize
        self.conf, self.traffic, self.device = conf, traffic, device
        self.cfg = RenderConfig(width=traffic["width"], height=traffic["height"],
                                max_tracing_depth=traffic["depth"], **conf.get("render", {}))
        self.made = scenes.inputs(conf)
        scene, self.scene_build_s = scenes.program_scene(conf, self.made, device)
        cam = conf["camera"]
        self.arrays = rcam.orbit_camera(random.Random(seed).uniform(0.0, 360.0),
                                        cam["pitch_deg"], cam["radius"], self.cfg.width,
                                        self.cfg.height, cam["fov_y_deg"])
        self.cam = Camera(**{k: torch.as_tensor(v) for k, v in self.arrays.items()})
        self.scene = scene
        params, rebuild = optimize.split_trainable(scene, device=device)
        h, w = self.cfg.height, self.cfg.width
        with torch.no_grad():
            self.target = optimize.render_flat(rebuild(params), self.cam, self.cfg, h, w, 0)
            base = params["materials"].base_color
            params["materials"] = params["materials"].replace(
                base_color=(base * 0.4 + 0.3).requires_grad_(True))
        lr = traffic["lr"]
        init, self._step = optimize.make_train_step(
            rebuild, self.cfg, h, w, lambda leaves: torch.optim.Adam(leaves, lr=lr))
        self.state = init(params)
        self.losses: list[float] = []
        self.pick = random.Random(seed ^ 0x5EED)
        self.seen = 0
        self.window: dict | None = None

    def leaves(self) -> dict:
        p = self.state.params
        out = {f"materials.{k}": getattr(p["materials"], k) for k in MATERIAL_FIELDS}
        out.update({f"lights.{k}": getattr(p["lights"], k) for k in ("position", "radiance")})
        return out

    def step(self):
        self.state, loss = self._step(self.state, self.target, self.cam, 0)
        return loss

    def warm_up(self) -> None:
        """The first steps, read for the check: each loss, the first
        gradient from Adam's state after one step, the leaves after the
        last."""
        for i in range(self.CHECKED_STEPS):
            self.losses.append(float(self.step()))
            if i == 0:
                opt = self.state.opt_state
                self.first_grad = {
                    k: (opt.state[v]["exp_avg"].detach().clone() / (1 - 0.9)
                        if v in opt.state else None)
                    for k, v in self.leaves().items()}
        self.after = {k: v.detach().clone() for k, v in self.leaves().items()}
        sync(self.device)

    def snapshot(self) -> dict:
        """The leaves and Adam's state of each ((exp_avg, exp_avg_sq, step),
        or None before its first update), copied to host memory."""
        opt = self.state.opt_state
        adam = {}
        for k, v in self.leaves().items():
            st = opt.state.get(v)
            adam[k] = (check.host(st["exp_avg"]), check.host(st["exp_avg_sq"]),
                       int(st["step"])) if st else None
        return dict(params={k: check.host(v) for k, v in self.leaves().items()}, adam=adam)

    def timed(self) -> float:
        """A window unit -> the seconds spent keeping it for the check,
        which the window's clock leaves out. One step of the window, drawn
        from the seed (reservoir sampling, decided before each step runs),
        is kept: the leaves and Adam's state before it, its loss, and both
        after it, copied to host memory."""
        keep = self.pick.randrange(self.seen + 1) == 0
        self.seen += 1
        if not keep:
            self.step()
            sync(self.device)
            return 0.0
        t = time.perf_counter()
        before = self.snapshot()
        paused = time.perf_counter() - t
        loss = self.step()
        sync(self.device)
        t = time.perf_counter()
        self.window = dict(before=before, loss=float(loss), after=self.snapshot(),
                           index=self.seen - 1)
        return paused + time.perf_counter() - t

    def untimed(self) -> None:
        self.step()

    @staticmethod
    def counts(rec) -> dict:
        return {}

    def check_inputs(self) -> dict:
        return dict(loss=self.losses, grad=self.first_grad, params=self.after,
                    window=self.window)

    def scene_context(self) -> dict:
        """The triangle rows the program holds (the primary-hit share is the
        reference's, printed by the check)."""
        return dict(triangle_rows=int(self.scene.triangles.count))

    def release(self) -> None:
        self.state = self.target = None

    def initial_leaves(self, device) -> dict:
        """The leaves before the first step, made by the harness from the
        configuration: its materials (base_color * 0.4 + 0.3) and lights."""
        spec = self.conf["scene"]
        mats = material_table_arrays([spec["material"]] if "material" in spec
                                     else spec["materials"])
        out = {f"materials.{k}": torch.as_tensor(mats[f"materials.{k}"], device=device)
               for k in MATERIAL_FIELDS}
        out["materials.base_color"] = out["materials.base_color"] * 0.4 + 0.3
        lights = spec["lights"]
        out["lights.position"] = torch.as_tensor(
            np.asarray([p for p, _ in lights], np.float32).reshape(-1, 3), device=device)
        out["lights.radiance"] = torch.as_tensor(
            np.asarray([r for _, r in lights], np.float32).reshape(-1, 3), device=device)
        return out


CLIENTS = {"orbit": Orbit, "train": Train, "orbit_sharded": OrbitSharded}

