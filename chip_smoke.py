#!/usr/bin/env python3
"""Smoke run of tpuray_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc, then:
  1. K1 (trace_packets) on the 640,000 camera primaries of an 800x800 frame
     of the 20,482-triangle test scene, against its plain PyTorch version;
  2. K2 (trace_multi) on that frame's bounce-0 classes (bounce ray, env
     shadow, point shadow), against its plain version;
  3. the main path: Renderer under the slice config, 2 warm-up frames, then
     16 moving-camera frames; checks the image, that both kernels ran, and
     one frame against the same frame rendered with the plain versions.
Any failed check raises (non-zero exit). The last two lines are the card's
name and power limit, then {"ok": true, "device": {...}}; the line before
them holds the kernels' launch counts, errors and times.
Needs no network and no jax. Exits non-zero without a CUDA device.
"""
import json
import statistics
import subprocess
import sys
import time

import torch

from tpuray_torch.integrator.intersect import INF
from tpuray_torch.integrator.path_tracer import trace_paths
from tpuray_torch.kernels import build
from tpuray_torch.kernels import trace as kt
from tpuray_torch.render.renderer import Renderer, camera_rays
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.procedural import make_test_scene

H = W = 800
SLICE = RenderConfig(width=W, height=H, enable_svgf=False, compact_frac=0.0,
                     compact_auto=False)
TIMED_FRAMES = 16
KERNEL_REPS = 20
MAX_MISMATCH = 1e-4  # idx / hit-miss may differ on at most 0.01% of rays


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_ms(fn, reps: int = KERNEL_REPS) -> float:
    """Mean device time of fn() over reps launches, after 3 warm-ups."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn):
    """(result, ms) of one call, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def check_closest(name, t, i, t_p, i_p):
    """idx equal but for exact-t ties; t bit-equal (so within rtol 1e-6)."""
    n = i.numel()
    diff = i != i_p
    n_diff = int(diff.sum())
    n_tie = int((diff & (t == t_p)).sum())
    both = (i >= 0) & (i_p >= 0)
    err = float((t[both] - t_p[both]).abs().max()) if bool(both.any()) else 0.0
    rel = float(((t[both] - t_p[both]).abs() / t_p[both].abs()).max()) if bool(both.any()) else 0.0
    log(f"{name}: rays={n} hits={int((i_p >= 0).sum())} idx_mismatch={n_diff} "
        f"(exact-t ties {n_tie}) max|dt|={err:.3g} max_rel_dt={rel:.3g}")
    if n_diff != n_tie:
        raise AssertionError(f"{name}: {n_diff - n_tie} idx mismatches are not t ties")
    if n_diff > MAX_MISMATCH * n:
        raise AssertionError(f"{name}: {n_diff} idx mismatches > {MAX_MISMATCH:.2%}")
    if rel > 1e-6:
        raise AssertionError(f"{name}: t differs by rtol {rel:.3g} > 1e-6")
    return err


def check_any(name, i, i_p):
    n = i.numel()
    n_diff = int(((i >= 0) != (i_p >= 0)).sum())
    log(f"{name}: rays={n} hits={int((i_p >= 0).sum())} hit_miss_mismatch={n_diff}")
    if n_diff > MAX_MISMATCH * n:
        raise AssertionError(f"{name}: {n_diff} hit/miss mismatches")


def assert_images_close(a, b, tol=5e-4, outlier_frac=0.005, outlier_max=0.1):
    """tests/test_dist_frame.py's image tolerance."""
    d = (a - b).abs().amax(-1)
    frac = float((d > tol).float().mean())
    dmax = float(d.max())
    log(f"frame kernel vs plain: pixels>{tol}={frac:.4%} max_diff={dmax:.3g}")
    if frac > outlier_frac or dmax >= outlier_max:
        raise AssertionError("kernel frame differs from the plain-version frame")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA device")
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- build
    t0 = time.perf_counter()
    build.load()
    how = (f"nvcc {build.build_seconds:.2f} s" if build.build_log
           else "already built from these sources")
    log(f"build: {time.perf_counter() - t0:.2f} s ({how}) -> {build.library_path()}")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- scene
    t0 = time.perf_counter()
    scene = make_test_scene(subdiv=5, env_width=512, device=dev)
    tables = kt.pack_scene(scene.bvh, scene.triangles)
    torch.cuda.synchronize()
    log(f"scene: {scene.triangles.count} triangles, {scene.bvh.count} nodes, "
        f"host build + upload {time.perf_counter() - t0:.2f} s")

    cam = OrbitCamera(width=W, height=H)
    camera = cam.snapshot(dev)
    orig, d, px, py = camera_rays(camera, H, W)

    # ---- K1: camera primaries
    t_k, i_k = kt.trace_packets(tables, orig, d, INF, common_origin=True)
    (t_p, i_p), k1_plain_ms = once_ms(
        lambda: kt.trace_packets_plain(tables, orig, d, INF, common_origin=True))
    k1_err = check_closest("K1 primaries", t_k, i_k, t_p, i_p)
    k1_ms = kernel_ms(lambda: kt.trace_packets(tables, orig, d, INF,
                                               common_origin=True))
    log(f"K1: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.1f} ms "
        f"({d.shape[0] / k1_ms / 1e3:.1f} Mrays/s)")

    # ---- K2: bounce-0 classes of the same frame, captured from the tracer
    captured = []

    def recording_multi(tabs, o, dirs, tms, ah):
        if not captured:
            captured.append((o.clone(), [x.clone() for x in dirs],
                             [x.clone() for x in tms], tuple(ah)))
        return kt.trace_multi(tabs, o, dirs, tms, ah)

    trace_paths(scene, orig, d, px, py, 0, SLICE, common_origin=True,
                tracer=kt.Tracer(packets=kt.trace_packets, multi=recording_multi),
                tables=tables)
    o2, dirs, tms, ah = captured[0]
    if ah != (False, True, True):
        raise AssertionError(f"bounce 0 classes {ah}, expected 3")
    got = kt.trace_multi(tables, o2, dirs, tms, ah)
    ref, k2_plain_ms = once_ms(lambda: kt.trace_multi_plain(tables, o2, dirs, tms, ah))
    k2_err = check_closest("K2 bounce class", got[0][0], got[0][1], *ref[0])
    check_any("K2 env-shadow class", got[1][1], ref[1][1])
    check_any("K2 point-shadow class", got[2][1], ref[2][1])
    k2_ms = kernel_ms(lambda: kt.trace_multi(tables, o2, dirs, tms, ah))
    log(f"K2: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.1f} ms "
        f"(live lanes {int((tms[0] > 0).sum())} of {o2.shape[0]})")

    # ---- the main path: moving-camera frames through the Renderer
    r = Renderer(scene, SLICE, device=dev)
    cam = OrbitCamera(width=W, height=H)
    for _ in range(2):
        r.step(cam.snapshot(dev))
        cam.rotate(0.5, 0.0)
    torch.cuda.synchronize()
    kt.reset_launches()
    frame_ms = []
    for _ in range(TIMED_FRAMES):
        cam.rotate(0.5, 0.0)
        t0 = time.perf_counter()
        out = r.step(cam.snapshot(dev))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kt.LAUNCHES)
    log(f"frames: {TIMED_FRAMES} at {W}x{H}, median {statistics.median(frame_ms):.3f} ms, "
        f"max {max(frame_ms):.3f} ms, min {min(frame_ms):.3f} ms, "
        f"coverage {float(out.coverage):.4f}, launches {launches}")
    if launches["k1"] < 1 or launches["k2"] < 1:
        raise AssertionError(f"the main path skipped a kernel: {launches}")
    img = out.final
    if tuple(img.shape) != (H, W, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("frame is not a finite (H, W, 3) image")
    if bool((img < 0).any()):
        raise AssertionError("frame has negative radiance")
    if not torch.equal(out.final, out.pt_color):
        raise AssertionError("with SVGF off, final must equal pt_color")
    if not 0.05 < float(out.coverage) < 1.0 or float(img.mean()) <= 0.0:
        raise AssertionError("implausible frame (coverage or mean)")

    # one frame with the plain versions forced, on the same card
    cam = OrbitCamera(width=W, height=H, yaw_deg=15.0)
    out_k = Renderer(scene, SLICE, device=dev).step(cam.snapshot(dev))
    out_p, plain_frame_ms = once_ms(
        lambda: Renderer(scene, SLICE, device=dev, tracer=kt.PLAIN).step(cam.snapshot(dev)))
    log(f"plain-version frame: {plain_frame_ms:.1f} ms (set-up included)")
    assert_images_close(out_k.pt_color, out_p.pt_color)

    kernels = [
        dict(name="K1 trace_packets", route="cuda", source="tpuray_torch/csrc/trace.cu",
             replaces="tpuray/kernels/trace_pallas.py:233", launches=launches["k1"],
             max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms),
        dict(name="K2 trace_multi", route="cuda", source="tpuray_torch/csrc/trace.cu",
             replaces="tpuray/kernels/trace_pallas.py:416", launches=launches["k2"],
             max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
