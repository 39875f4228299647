"""Benchmark: bench.py's headline and auxiliary metrics through the port's
CUDA kernels (counterpart of the repository's bench.py).

    python -m tpuray_torch.bench [--device cuda|cpu] [--full]
    python -m tpuray_torch.cli.main bench [--device cpu]

stdout: ONE JSON line {"metric", "value", "unit", "vs_baseline"}, the
headline traversal throughput of K1 (kernels/trace.py:trace_packets) on
the 640,000 camera primaries of an 800x800 frame, with "spread_mrays" on
the card. stderr: one JSON line per auxiliary metric under bench.py's
names, units and keys: K3 on incoherent rays, the moving 800x800 frame,
the SVGF chain at 1920x1080, the six gradient checks, K6 on the 131k and
524k forests, then bench_total_s. A metric that raises prints
{"metric", "error", "traceback"} instead, and the others still run. On the
card every line also carries "launches": the kernel launches of that
metric's run, counted from 0 just before it (kernels.launches()).

Times are host clock around back-to-back calls with one synchronising copy
a trial (timed_stats), as bench.py takes them: the headline is the wrapper's
rate (host call included), not K1's device time alone (chip_smoke.py phase
22 times that on the same rays). With --device cpu only the headline runs,
at 128x128 through the plain traversal. Without a CUDA device and without
--device cpu the bench raises before it prints anything.

Env: BENCH_BUDGET_S (default 780) caps the run, each auxiliary metric
running only if its estimated cost (EST_S) still fits; BENCH_FULL=1 (or
--full) runs every metric.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import numpy as np
import torch

from tpuray_torch import kernels
from tpuray_torch.integrator.intersect import INF
from tpuray_torch.kernels import trace as kt

# the project's targets (BASELINE.md), not measurements of any device
BASELINE_RAYS_PER_S = 100e6
BASELINE_FPS = 15.0
GRAD_SIZE = 128
M32 = 0xFFFFFFFF
# seconds each auxiliary metric may take on the card, set-up included: its
# measured cost on an H100 (frame 2.0, svgf 0.2, gradcheck 2.1, 131k 1.7,
# 524k 6.7 s; PERF.md section 6) with a margin
EST_S = {"frame": 10.0, "svgf": 5.0, "gradcheck": 10.0, "131k": 10.0, "524k": 30.0}
# bench.py's gradient checks (bench.py:325-432): name, point, FD step,
# tolerance on the relative error; light_pos_interior checks the order of
# magnitude only, roughness_d2 that AD gives a finite nonzero gradient
GRADCHECKS = (("base_color", 0.8, 1e-2, 0.05), ("specular", 0.9, 1e-2, 0.05),
              ("sheen", 0.9, 1e-2, 0.05), ("light_radiance", 0.9, 1e-2, 0.05),
              ("light_pos_interior", 0.0, 5e-3, None), ("roughness_d2", 0.9, None, None))


class Budget:
    """bench.py's wall-clock budget, from the moment it is made."""

    def __init__(self, budget_s: float, full: bool):
        self.t0 = time.perf_counter()
        self.budget_s, self.full = budget_s, full

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def have_time(self, estimate_s: float) -> bool:
        return self.full or self.elapsed() + estimate_s < self.budget_s


def emit(obj: dict, to_stdout: bool = False) -> None:
    print(json.dumps(obj), file=sys.stdout if to_stdout else sys.stderr, flush=True)


def timed_stats(fn, sync, iters: int, trials: int = 3) -> dict:
    """Per-call seconds across trials, {min, median, max}: one warm-up call,
    then `trials` runs of `iters` back-to-back calls, each run ended by one
    sync."""
    fn()
    sync()
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        ts.append((time.perf_counter() - t0) / iters)
    ts.sort()
    return {"min": ts[0], "median": ts[len(ts) // 2], "max": ts[-1]}


def spread_ms(st: dict) -> dict:
    return {k: round(v * 1e3, 2) for k, v in st.items()}


def spread_mrays(n: int, st: dict) -> dict:
    return {"min": round(n / st["max"] / 1e6, 1), "median": round(n / st["median"] / 1e6, 1),
            "max": round(n / st["min"] / 1e6, 1)}


def flagship_scene(device) -> tuple[object, str]:
    """The reference's clock model when an asset root has it, else the
    procedural test scene at subdiv 3 (1,282 triangles, a single tree)."""
    from tpuray_torch.scene.builder import reference_default_scene
    from tpuray_torch.scene.procedural import make_test_scene
    try:
        return reference_default_scene(device=device), "reference_default_scene"
    except FileNotFoundError:
        return make_test_scene(subdiv=3, device=device), "make_test_scene(subdiv=3)"


def primary_rays(cam, height: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """bench.py:95-105: the camera rays of a height x width frame in
    tile-major order, in host numpy -> (o, d), each (N, 3) float32 (N counts
    the padding to whole 32x32 tiles). cam: an OrbitCamera snapshot on the
    host."""
    from tpuray_torch.render.tiling import tile_pixel_coords
    xx, yy = (x.numpy() for x in tile_pixel_coords(height, width))
    n = int(xx.shape[0])
    tan = float(cam.tan_half_fov)
    xs = (2.0 * (xx.astype(np.float32) + 0.5) / width - 1.0) * tan
    ys = -(2.0 * (yy.astype(np.float32) + 0.5) / height - 1.0) * tan
    d_cam = np.stack([xs, ys, -np.ones_like(xs)], axis=-1)
    d = d_cam @ np.asarray(cam.cam_to_world, np.float32).T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.asarray(cam.eye, np.float32), (n, 3))
    return o, d


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """bench.py's uint32 hash (bench.py:186-191) on int64 tensors that hold
    uint32 values: torch's uint32 lacks these operators on CUDA, so each
    product is masked back to 32 bits, as uint32 arithmetic wraps."""
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & M32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & M32
    return x ^ (x >> 15)


def hash_uniforms(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """bench.py's u1, u2 (N,) float32 in [0, 1) of ray i."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    u1 = hash_u32(i).to(torch.float32) / np.float32(2**32)
    u2 = hash_u32((i * 7919) & M32).to(torch.float32) / np.float32(2**32)
    return u1, u2


def incoherent_inputs(o: torch.Tensor, d: torch.Tensor, t: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """bench.py:183-198: origins on the primaries' hits (10 along the ray
    on a miss) and hashed directions over the whole sphere -> (p, dirs)."""
    p = o + d * torch.clamp_max(t, 10.0)[:, None]
    u1, u2 = hash_uniforms(d.shape[0], d.device)
    ct = 1.0 - 2.0 * u1
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    phi = 2.0 * np.pi * u2
    return p, torch.stack([st * torch.cos(phi), ct, st * torch.sin(phi)], -1)


def svgf_inputs(height: int, width: int, device, seed: int = 0):
    """bench.py:266-286's random denoiser inputs, from a seeded generator on
    `device` -> (gbuf, state, color, emission, albedo). The albedo reuses
    the normal's draw, as bench.py reuses its key."""
    from tpuray_torch.integrator.gbuffer import GBuffer
    from tpuray_torch.render.frame_state import FrameState
    gen = torch.Generator(device=device).manual_seed(seed)

    def img(*c):
        return torch.rand((height, width, *c), generator=gen, device=device)

    raw = img(3)
    nrm = raw * 2 - 1
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    world_pos, linear_z, velocity = img(3) * 4 - 2, img() * 0.9, (img(2) - 0.5) * 0.01
    gbuf = GBuffer(normal=nrm, linear_z=linear_z, velocity=velocity,
                   fwidth_normal=img() * 0.1, fwidth_z=img() * 0.01, world_pos=world_pos)
    state = FrameState.initial(height, width, device).replace(
        illum_hist=img(3), variance_hist=img() * 0.1, prev_normal=nrm,
        prev_linear_z=linear_z, moments=img(2),
        history_len=torch.full((height, width), 8.0, device=device), frame_idx=8)
    return gbuf, state, img(3), img(3) * 0.05, raw + 0.2


def scaled_scene(scene, scales: dict):
    """The scene with each named gradient check's scale applied
    (bench.py:364-427): base_color |base_color| * s, specular and sheen
    0.5 * s, light_radiance radiance * s, light_pos_interior every light
    moved by s along x, roughness_d2 clip(|roughness| * s, 0.05, 1)."""
    m, lights = scene.materials, scene.lights
    mats, lts = {}, {}
    if "base_color" in scales:
        mats["base_color"] = torch.abs(m.base_color) * scales["base_color"]
    if "specular" in scales:
        mats["specular"] = torch.full_like(m.specular, 0.5) * scales["specular"]
    if "sheen" in scales:
        mats["sheen"] = torch.full_like(m.sheen, 0.5) * scales["sheen"]
    if "roughness_d2" in scales:
        mats["roughness"] = torch.clamp(torch.abs(m.roughness) * scales["roughness_d2"],
                                        0.05, 1.0)
    if "light_radiance" in scales:
        lts["radiance"] = lights.radiance * scales["light_radiance"]
    if "light_pos_interior" in scales:
        lp = lights.position
        z = torch.zeros(lp.shape[:1], device=lp.device)
        dx = torch.as_tensor(scales["light_pos_interior"], device=lp.device)
        lts["position"] = lp + torch.stack([dx.expand(lp.shape[:1]), z, z], dim=-1)
    return scene.replace(materials=m.replace(**mats), lights=lights.replace(**lts))


def gradcheck_config(size: int = GRAD_SIZE):
    """bench.py's: depth 2, SVGF off, every other field at its default
    (compaction on)."""
    from tpuray_torch.scene.config import RenderConfig
    return RenderConfig(width=size, height=size, max_tracing_depth=2, enable_svgf=False)


def gradcheck_lines(scene, tables, device, size: int = GRAD_SIZE):
    """bench.py's six gradient checks, one metric line each as it is
    computed: AD of mean(pt_color) in each check's scale against central FD
    (relative error below the tolerance; light_pos_interior the ratio in
    (0.3, 3): FD also measures the hard shadows' boundary flux, which AD
    leaves out by construction), and roughness's AD gradient finite and
    nonzero. The mean is accumulated in float64: the float32 mean loses
    several percent of a small FD difference to rounding; its FD is printed
    beside ("fd_f32_mean")."""
    from tpuray_torch.render.frame_state import FrameState
    from tpuray_torch.render.renderer import render_frame
    from tpuray_torch.scene.camera import OrbitCamera
    cfg = gradcheck_config(size)
    cam = OrbitCamera(width=size, height=size).snapshot(device)
    st0 = FrameState.initial(size, size, device)

    def image(name, s):
        _, out = render_frame(scaled_scene(scene, {name: s}), cam, st0, cfg, size, size,
                              tables=tables)
        return out.pt_color

    def scale(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    for name, x0, eps, tol in GRADCHECKS:
        if name.startswith("light") and scene.lights.count == 0:
            continue
        s = scale(x0).requires_grad_()
        image(name, s).double().mean().backward()
        g = float(s.grad)
        if eps is None:
            yield {"metric": f"gradcheck_{name}_ad_sanity", "value": g,
                   "unit": "dloss/dscale", "pass": math.isfinite(g) and abs(g) > 1e-10}
            continue
        with torch.no_grad():
            hi, lo = image(name, scale(x0 + eps)), image(name, scale(x0 - eps))
        fd = float(hi.double().mean() - lo.double().mean()) / (2 * eps)
        fd32 = (float(hi.mean()) - float(lo.mean())) / (2 * eps)
        rel = abs(g - fd) / max(abs(fd), 1e-8)
        line = {"metric": f"gradcheck_{name}_rel_err", "value": rel, "unit": "relative",
                "grad": g, "fd": fd, "fd_f32_mean": fd32}
        if tol is None:
            ratio = g / fd if abs(fd) > 1e-10 else float("inf")
            line.update({"pass": math.isfinite(g) and 0.3 < ratio < 3.0,
                         "mode": "order_only"})
        else:
            line["pass"] = rel < tol
        yield line


def _error(metric: str, e: Exception) -> None:
    emit({"metric": metric, "error": repr(e)[:200],
          "traceback": traceback.format_exc()[-2000:]})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpuray_torch.bench")
    p.add_argument("--device", default="cuda",
                   help="cuda (raises without a CUDA device) or cpu (the headline only)")
    p.add_argument("--full", action="store_true", help="ignore BENCH_BUDGET_S")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"bench: unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device is available; pass --device cpu to "
                           "run the headline on the CPU")
    budget = Budget(float(os.environ.get("BENCH_BUDGET_S", "780")),
                    args.full or os.environ.get("BENCH_FULL") == "1")
    on_card = dev.type == "cuda"

    def launch_counts(line: dict) -> dict:
        if on_card:
            torch.cuda.synchronize()
            line["launches"] = {k: n for k, n in kernels.launches().items() if n}
        return line

    from tpuray_torch.integrator.path_tracer import pack_traversal
    from tpuray_torch.scene.camera import OrbitCamera
    scene, scene_name = flagship_scene(dev)
    emit({"scene": scene_name, "triangles": int(scene.triangles.count)})
    size = 800 if on_card else 128
    o_np, d_np = primary_rays(OrbitCamera(width=size, height=size).snapshot(), size, size)
    n_rays = int(d_np.shape[0])
    with torch.no_grad():
        tables = pack_traversal(scene)
    if tables.chunk_nodes:
        raise ValueError(f"{scene_name} is a chunked forest; the headline's K1 walks a "
                         "single tree")
    o = torch.from_numpy(np.ascontiguousarray(o_np)).to(dev)
    d = torch.from_numpy(d_np).to(dev)
    state = {}

    # ---- headline: K1 on the camera primaries, the tables packed once
    def run():
        state["out"] = kt.trace_packets(tables, o, d, INF, common_origin=True)

    def sync():
        state["out"][0][:1].cpu()

    kernels.reset_launches()
    st = (timed_stats(run, sync, iters=20, trials=6) if on_card
          else timed_stats(run, sync, iters=3, trials=1))
    rays_per_s = n_rays / st["min"]
    line = {"metric": "trace_rays_per_second", "value": rays_per_s, "unit": "rays/s",
            "vs_baseline": rays_per_s / BASELINE_RAYS_PER_S}
    if not on_card:
        emit(line, to_stdout=True)
        return 0
    line["spread_mrays"] = spread_mrays(n_rays, st)
    emit(launch_counts(line), to_stdout=True)

    # ---- K3 on incoherent rays from the primaries' hits
    tm = torch.full((n_rays,), INF, device=dev)
    try:
        p_inc, d_inc = incoherent_inputs(o, d, state["out"][0])

        def run_inc():
            state["inc"] = kt.trace_batched(tables, p_inc, d_inc, tm)

        def sync_inc():
            state["inc"][0][:1].cpu()

        kernels.reset_launches()
        st = timed_stats(run_inc, sync_inc, iters=8, trials=3)
        emit(launch_counts({
            "metric": "trace_incoherent_rays_per_second", "value": n_rays / st["min"],
            "unit": "rays/s", "spread_mrays": spread_mrays(n_rays, st),
            "vs_baseline": n_rays / st["min"] / BASELINE_RAYS_PER_S}))
    except Exception as e:  # an auxiliary metric must not stop the others
        _error("trace_incoherent_rays_per_second", e)

    # ---- the moving 800x800 frame under RenderConfig() (compaction on)
    if budget.have_time(EST_S["frame"]):
        metric = f"frame_ms_moving_{size}px"
        try:
            from tpuray_torch.render.renderer import Renderer
            from tpuray_torch.scene.config import RenderConfig
            r = Renderer(scene, RenderConfig(width=size, height=size), device=dev)
            ocam = OrbitCamera(width=size, height=size)

            def frame_moving():
                ocam.rotate(0.05, 0.0)
                state["frame"] = r.step(ocam.snapshot())

            def sync_f():
                state["frame"].final[:1, :1].cpu()

            kernels.reset_launches()
            st = timed_stats(frame_moving, sync_f, iters=8, trials=3)
            emit(launch_counts({
                "metric": metric, "value": round(st["min"] * 1e3, 2), "unit": "ms/frame",
                "spread_ms": spread_ms(st), "fps": round(1.0 / st["min"], 1),
                "vs_baseline": (1.0 / st["min"]) / BASELINE_FPS}))
            del r, state["frame"]
        except Exception as e:
            _error(metric, e)

    # ---- the SVGF chain at 1920x1080 (K4 once, K5 five times, TAA)
    if budget.have_time(EST_S["svgf"]):
        try:
            from tpuray_torch.denoise.svgf import svgf_pipeline
            from tpuray_torch.scene.config import RenderConfig
            h, w = 1080, 1920
            cfg = RenderConfig(width=w, height=h)
            gbuf, fstate, color, emi, alb = svgf_inputs(h, w, dev)

            def run_s():
                state["svgf"] = svgf_pipeline(color, emi, alb, gbuf, fstate, cfg,
                                              static_camera=False).taa

            def sync_s():
                state["svgf"][:1, :1].cpu()

            kernels.reset_launches()
            st = timed_stats(run_s, sync_s, iters=5, trials=3)
            emit(launch_counts({"metric": "svgf_chain_ms_moving_1080p",
                                "value": round(st["min"] * 1e3, 2), "unit": "ms",
                                "spread_ms": spread_ms(st)}))
            del gbuf, fstate, color, emi, alb, state["svgf"]
        except Exception as e:
            _error("svgf_chain_ms_moving_1080p", e)

    # ---- gradient fidelity: AD against central FD, 128x128, SVGF off
    if budget.have_time(EST_S["gradcheck"]):
        try:
            kernels.reset_launches()
            for line in gradcheck_lines(scene, tables, dev):
                emit(launch_counts(line))
                kernels.reset_launches()
        except Exception as e:
            _error("gradcheck_rel_err", e)

    # ---- K6 on the 131k and 524k forests (16 and 64 chunks), the primaries
    from tpuray_torch.kernels import trace_chunked as ktc
    from tpuray_torch.scene.procedural import make_large_scene
    for label, subdiv in (("131k", 4), ("524k", 5)):
        if not budget.have_time(EST_S[label]):
            continue
        metric = f"trace_chunked_{label}_rays_per_second"
        try:
            big = make_large_scene(n_spheres=25, subdiv=subdiv, env_width=64, device=dev)
            forest = ktc.pack_forest(big.bvh, big.triangles)

            def run_big():
                state["big"] = ktc.trace_chunked(forest, o, d, tm, common_origin=True)

            def sync_big():
                state["big"][0][:1].cpu()

            kernels.reset_launches()
            st = timed_stats(run_big, sync_big, iters=8, trials=3)
            emit(launch_counts({
                "metric": metric, "value": n_rays / st["min"], "unit": "rays/s",
                "tris": int(big.triangles.count), "chunks": forest.n_chunks,
                "spread_mrays": spread_mrays(n_rays, st),
                "vs_baseline": n_rays / st["min"] / BASELINE_RAYS_PER_S}))
            del big, forest, state["big"]
        except Exception as e:
            _error(metric, e)

    emit({"metric": "bench_total_s", "value": round(budget.elapsed(), 1), "unit": "s"})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
