#!/usr/bin/env python3
"""Smoke run of tpuray_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc (one process per source) and
prints each kernel's registers, stack frame, spill stores and shared memory
a block (ptxas -v; every kernel's shared memory is static) and the FP64
instructions in its SASS (cuobjdump -sass), then:
  1. K1 (trace_packets) on the 640,000 camera primaries of an 800x800 frame
     of the 20,482-triangle test scene, against its plain PyTorch version;
  2. K2 (trace_multi) on that frame's bounce-0 classes (bounce ray, env
     shadow, point shadow), against its plain version, then each class
     against K3 (trace_batched) on that class alone, with the three K3
     times beside K2's;
  3. K4 (reproject_variance_fused) on the denoiser's inputs of the 5th frame
     of a moving 800x800 Renderer, against its plain version, with the
     inputs' shares of sky and fallback pixels and of blocks with a
     fallback pixel;
  4. K5 (atrous_chain, 5 iterations) on K4's output, against its plain
     version, timed at 1 to 5 iterations: each step's time beside the
     chain's;
  5. slice 2's path: Renderer under the slice config (SVGF and TAA on, the
     default view), 2 warm-up frames, then 16 moving-camera frames with the
     launch counts set to 0 just before and read just after; checks the
     image and that every kernel ran; then 2 frames with the camera still
     (the static-camera branch); then 3 frames through the kernels against
     the same 3 frames through the plain versions;
  6. slice 1's path (SVGF off): 8 moving frames and one frame against the
     plain-version frame;
  7. the SVGF chain (K4, K5 x 5, modulate, TAA) on one 1920x1080 frame's
     inputs, the median of 10;
  8. K6 (trace_chunked) on the 131k-triangle forest (make_large_scene(25
     spheres, subdiv 4): 128,002 triangles in 16 chunks): the 640,000
     primaries of an 800x800 frame and the frame's other five walks
     (bounce-0 env shadow, point shadow and bounce ray, bounce-1 env and
     point shadow), each against its plain version and timed;
  9. K6 on the 524k-triangle forest (subdiv 5: 512,002 triangles in 64
     chunks): the primaries and the bounce-0 bounce rays;
 10. slice 3's main path: the 131k forest under the slice config, 2 warm-up
     frames then 16 moving frames (launches: K6 6 a frame, K4 1, K5 5, K1,
     K2 and K3 none), then 2 frames at 256x256 through the kernels against
     the plain versions;
 11. K3 (trace_batched) on one frame's bounce-0 env-shadow and continuation
     rays of the separate-walk (fused_secondary=False) and MIS integrators
     on the test scene, against its plain version;
 12. 8 moving MIS frames and 8 moving separate-walk frames at 800x800
     (launches: K1 1 and K3 5 a frame each), and 2 frames of each through
     the kernels against the plain versions;
 13. K7 (onehot_gather, on no path) at the main path's shapes: the
     triangle table (20,482 x 26) at the 640,000 clamped primary hit
     indices of phase 1, the material table at those hits' mat_id, and an
     (11k, 44) table at 640k random indices; bit-exact against its plain
     version, within 2^-16 relative of table[idx] (the library yardstick);
 14. the JAX package's six gradient checks (bench.py:307-434) through
     render_frame with SVGF off, 128x128, depth 2: central FD against AD
     for base_color, specular, sheen and light_radiance (relative error
     < 0.05), light_pos_interior (order only, ratio in (0.3, 3)) and the
     roughness AD sanity (finite, |g| > 1e-10);
 15. the trainer (cli/main.py:cmd_train's recovery) at 800x800, depth 2:
     the target from render_flat, base_color * 0.4 + 0.3, then 5
     make_train_step steps (every material and light field differentiated,
     Adam with lr 1e-2 on base_color, the perturbed field) with the launch
     counts set to 0 just before and read just after (K1 1 and K2 2 a
     step); the loss must fall; then one step's gradients through the
     kernels against the plain tracer's at 256x256.
Any failed check raises (non-zero exit). The last lines are the kernels'
JSON line (launches: the sum over every path run above, each run counted
from 0 just before it; errors, times and bounds from phases 1-4, 8, 11 and
13), the card's name and power limit, then {"ok": true, "device": {...}}.
Needs no network and no jax. Exits non-zero without a CUDA device.
"""
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch

from tpuray_torch.denoise.svgf import svgf_pipeline
from tpuray_torch.integrator import path_tracer as pt
from tpuray_torch.integrator.gather_tables import fetch_tri, pack_scene_tables
from tpuray_torch.integrator.intersect import INF
from tpuray_torch.kernels import atrous as ka
from tpuray_torch.kernels import build
from tpuray_torch.kernels import gather as kg
from tpuray_torch.kernels import reproject as kr
from tpuray_torch.kernels import trace as kt
from tpuray_torch.kernels import trace_chunked as ktc
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.render.renderer import Renderer, camera_rays, render_frame
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.procedural import make_large_scene, make_test_scene
from tpuray_torch.train import optimize
from tpuray_torch.denoise_times import (
    chain_times, fallback_shares, moving_renderer, step_increments)
from tpuray_torch.traversal_times import kernel_ms, recorded_calls

H = W = 800
# slice 2: the default view (SVGF + TAA on) without compaction (item 10)
SLICE = RenderConfig(width=W, height=H, compact_frac=0.0, compact_auto=False)
SLICE_PLAIN = dataclasses.replace(SLICE, pallas_denoise=False)
SLICE1 = dataclasses.replace(SLICE, enable_svgf=False)  # slice 1: SVGF off
SEPARATE = dataclasses.replace(SLICE, fused_secondary=False)  # slice 3, path 2
MIS = dataclasses.replace(SLICE, integrator="mis")  # slice 3, path 3
TIMED_FRAMES = 16
SLICE1_FRAMES = 8
SLICE3_FRAMES = 8  # MIS and separate-walk frames
FOREST_CHECK_SIZE = 256  # forest frames against the plain versions
LARGE_CAM = dict(radius=4.0)  # sees the sphere field (tests/test_partition.py)
KERNEL_REPS = 20
GRAD_SIZE = 128     # bench.py's gradient checks
TRAIN_STEPS = 5     # the trainer at W x H
TRAIN_CHECK_SIZE = 256  # train-step gradients, kernels against plain
GRAD_ATOL = 1e-4    # of each field's largest |gradient|: table[idx]'s backward sums with atomics
MAX_MISMATCH = 1e-4  # idx / hit-miss / validity may differ on <= 0.01%
RTOL, ATOL = 1e-5, 1e-6  # K4 and K5 against their plain versions

# H100 SXM published peaks (NVIDIA's data sheet, 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float operations per unit of work, counted from the code:
BOX_OPS = 26    # intersect.ray_aabb: 12 sub/mul, 6 min/max, 4 reductions, 4 compares
TRI_OPS = 38    # intersect.ray_triangle_pre: 2 dots, divide, point, 2 planes, 6 tests
K4_PIXEL_OPS = 190      # reproject pass: demodulate, uv, 4 taps x 30, EMA tail
K4_RESCUE_OPS = 580     # + 16 rescue taps x 36, where the reprojection failed
K4_FALLBACK_OPS = 2156  # + 7x7 fallback, 49 taps x 44, where history < 4
# one a-trous iteration, the least a non-sky pixel needs: 24 taps x 35 (normal
# dot 5, clamp 2, 7 squarings, depth and luminance terms 3 each (sub, abs,
# multiply by a per-pixel reciprocal), exp and its argument 2, times w_normal
# 1, kernel weight and mask 2, accumulations 10 (sum_w 1, rgb 6, variance 3))
# + 41 (own luminance 5 (each point's taken once), pre-blur 17, phi_l 5,
# phi_depth 2, reciprocals 7, outputs 5)
K5_PIXEL_OPS = 24 * 35 + 41


class ChainOut(NamedTuple):  # K5's outputs, for check_fields
    illum: torch.Tensor
    variance: torch.Tensor
    tap_illum: torch.Tensor
    tap_variance: torch.Tensor


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = KERNEL_REPS) -> float:
    """Median device time of reps launches of fn(), each between its own
    pair of events, after 3 warm-ups."""
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def once_ms(fn):
    """(result, ms) of one call, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms the card could take, which term bounds it)."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def reset_launches() -> None:
    kt.reset_launches()
    ktc.reset_launches()
    kr.reset_launches()
    ka.reset_launches()
    kg.reset_launches()


def launches() -> dict:
    return {**kt.LAUNCHES, **ktc.LAUNCHES, **kr.LAUNCHES, **ka.LAUNCHES,
            **kg.LAUNCHES}


def check_closest(name, t, i, t_p, i_p):
    """idx equal but for exact-t ties; t bit-equal."""
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
    if not torch.equal(t, t_p):
        raise AssertionError(f"{name}: t is not bit-equal (max rel {rel:.3g})")
    return err


def check_any(name, i, i_p):
    n = i.numel()
    n_diff = int(((i >= 0) != (i_p >= 0)).sum())
    log(f"{name}: rays={n} hits={int((i_p >= 0).sum())} hit_miss_mismatch={n_diff}")
    if n_diff > MAX_MISMATCH * n:
        raise AssertionError(f"{name}: {n_diff} hit/miss mismatches")


def check_fields(name, got, ref, valid=None) -> float:
    """Every field of got within RTOL / ATOL of ref (where valid); returns
    the largest absolute difference."""
    err = 0.0
    for f in got._fields:
        a, b = getattr(got, f), getattr(ref, f)
        if valid is not None:
            a, b = a[valid], b[valid]
        d = (a - b).abs()
        bad = int((d > ATOL + RTOL * b.abs()).sum())
        err = max(err, float(d.max()) if d.numel() else 0.0)
        if bad or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}.{f}: {bad} values beyond rtol {RTOL} / "
                                 f"atol {ATOL} (max |diff| {float(d.max()):.3g})")
    log(f"{name}: {len(got._fields)} outputs within rtol {RTOL} / atol {ATOL}, "
        f"max |diff| {err:.3g}")
    return err


def assert_images_close(name, a, b, tol=5e-4, outlier_frac=0.005, outlier_max=0.1):
    """tests/test_dist_frame.py's image tolerance."""
    d = (a - b).abs().amax(-1)
    frac = float((d > tol).float().mean())
    dmax = float(d.max())
    log(f"{name}: pixels>{tol}={frac:.4%} max_diff={dmax:.3g}")
    if frac > outlier_frac or dmax >= outlier_max:
        raise AssertionError(f"{name}: the kernel frame differs from the plain-version frame")


def check_image(out, svgf_on: bool) -> None:
    img = out.final
    if img.shape != out.pt_color.shape or img.shape[-1] != 3:
        raise AssertionError(f"frame has shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("frame is not finite")
    if not svgf_on and bool((img < 0).any()):
        raise AssertionError("frame has negative radiance")
    if svgf_on == torch.equal(out.final, out.pt_color):
        raise AssertionError("final equals pt_color with SVGF on, or differs with it off")
    if not 0.05 < float(out.coverage) < 1.0 or float(img.mean()) <= 0.0:
        raise AssertionError("implausible frame (coverage or mean)")


def trace_bound(tables, stats, *tensors):
    """K1/K3/K6's bound: the tables and the rays' bytes once, and the box
    and triangle tests these rays needed (the plain walk's count)."""
    return bound(nbytes(tables.meta, tables.aabb, tables.tverts, *tensors),
                 stats["box_tests"] * BOX_OPS + stats["tri_tests"] * TRI_OPS)


def ptxas_summary(text: str) -> dict:
    """{kernel: (registers, stack-frame bytes, spill-store bytes, static
    shared-memory bytes a block)} from the build's `-Xptxas -v` report;
    names demangled as `trace_k2<3>`. The kernels ask for no dynamic shared
    memory."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = _demangle(m.group(1))
            out[cur] = [0, 0, 0, 0]
        elif cur and "bytes stack frame" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[cur][1], out[cur][2] = nums[0], nums[1]
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            out[cur][0] = int(m.group(1))
            if sm := re.search(r"(\d+) bytes smem", line):
                out[cur][3] = int(sm.group(1))
    return {k: tuple(v) for k, v in out.items()}


def _demangle(name: str) -> str:
    """`_ZN<n>_GLOBAL__N_<file hash>8trace_k2ILi3EEEv...` -> `trace_k2<3>`
    (kernels in an anonymous namespace with bool / int template arguments;
    `Lin1E` is -1)."""
    m = re.match(r"_ZN(\d+)", name)
    if not m or "_GLOBAL__N_" not in name:
        return name
    rest = name[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return name
    n = int(m.group(1))
    base, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
    if not rest.startswith("I"):
        return base
    args = re.findall(r"L([bi])(n?\d+)E", rest[:rest.find("EE") + 2])
    vals = [("true" if v == "1" else "false") if k == "b" else v.replace("n", "-")
            for k, v in args]
    return f"{base}<{', '.join(vals)}>"


def fp64_in_sass(lib: Path) -> dict:
    """{kernel: FP64 instructions in its SASS} from `cuobjdump -sass` of the
    built library (the toolkit's, beside nvcc)."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\w+)", line):
            cur = _demangle(m.group(1))
            out[cur] = 0
        elif cur and re.search(r"\b(DADD|DMUL|DFMA|DSETP|DMNMX|DSET)\b|\.F64|64H\b", line):
            out[cur] += 1
    return out


def check_class(name, kernel, plain, tables, args, any_hit, reps=KERNEL_REPS):
    """One ray class through a traversal kernel and its plain version:
    parity, the kernel's time, the plain version's time, work and bound.
    args: (orig, d, t_max) and the kernel's remaining positional args."""
    t_k, i_k = kernel(tables, *args)
    (t_p, i_p), plain_ms = once_ms(lambda: plain(tables, *args))
    err = 0.0
    if any_hit:
        check_any(name, i_k, i_p)
    else:
        err = check_closest(name, t_k, i_k, t_p, i_p)
    n = args[1].shape[0]
    tm = kt._rays_tmax(args[2], n, args[1].device)
    # timed with the per-ray t_max: a float is copied to the card, and waited
    # for, on every call
    ms = kernel_ms(lambda: kernel(tables, args[0], args[1], tm, *args[3:]), reps)
    work = {}
    plain(tables, *args, stats=work)
    live = int((tm > 0).sum())
    b = trace_bound(tables, work, args[0], args[1], tm, t_k, i_k)
    log(f"{name}: kernel {ms:.4f} ms ({n / ms / 1e3:.1f} Mrays/s, {live} live "
        f"of {n}), plain {plain_ms:.1f} ms; work {work}; bound {b[0]:.4f} ms "
        f"by {b[1]}")
    return err, ms, plain_ms, b


def phase_k2_vs_k3(tables, orig, dirs, tms, ah, got, k2_ms) -> None:
    """2b. K2 against one K3 (trace_batched) walk per class on the same
    rays: each class's result, and the three walks' times beside K2's."""
    names = ("bounce ray", "env shadow", "point shadow")
    per_class = []
    for c, name in enumerate(names[:len(dirs)]):
        t3, i3 = kt.trace_batched(tables, orig, dirs[c], tms[c], ah[c])
        if ah[c]:
            check_any(f"K2 {name} vs K3 alone", got[c][1], i3)
        else:
            check_closest(f"K2 {name} vs K3 alone", got[c][0], got[c][1], t3, i3)
        per_class.append(kernel_ms(lambda c=c: kt.trace_batched(
            tables, orig, dirs[c], tms[c], ah[c])))
    all3 = kernel_ms(lambda: [kt.trace_batched(tables, orig, dirs[c], tms[c], ah[c])
                              for c in range(len(dirs))])
    log(f"K2 vs K3 per class, bounce 0: K2 {k2_ms:.4f} ms; K3 "
        + " + ".join(f"{n} {ms:.4f}" for n, ms in zip(names, per_class))
        + f" = {sum(per_class):.4f} ms (back to back {all3:.4f} ms)")


def timed_frames(r, cam, frames: int) -> tuple[list, dict, object]:
    """`frames` moving synchronised frames with the launch counts set to 0
    just before and read just after -> (ms per frame, launches, last out)."""
    torch.cuda.synchronize()
    reset_launches()
    ms, out = [], None
    for _ in range(frames):
        cam.rotate(0.5, 0.0)
        t0 = time.perf_counter()
        out = r.step(cam.snapshot())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, launches(), out


def add_launches(total: dict, run: dict) -> None:
    for k, n in run.items():
        total[k] += n


def expect_launches(name, got: dict, want: dict) -> None:
    bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
    if bad:
        raise AssertionError(f"{name}: launches (got, want) {bad}")


def check_k7(name, table, idx):
    """K7 on one (table, idx) pair: bit-exact against its plain version,
    within 2^-16 relative of table[idx]; kernel, plain and table[idx]
    times and the bound."""
    got = kg.onehot_gather(table, idx)
    want, plain_ms = once_ms(lambda: kg.onehot_gather_plain(table, idx))
    if not torch.equal(got, want):
        n_bad = int((got != want).sum())
        raise AssertionError(f"K7 {name}: {n_bad} values differ from the plain version")
    lib = table[idx]
    rel = float(((got - lib).abs() / lib.abs().clamp_min(2.0 ** -126)).max())
    if rel > 2.0 ** -16:
        raise AssertionError(f"K7 {name}: {rel:.3g} relative from table[idx] > 2^-16")
    ms = median_ms(lambda: kg.onehot_gather(table, idx))
    lib_ms = median_ms(lambda: table[idx])
    b = bound(nbytes(table, idx, got), got.numel() * 4)  # 2 roundings, a subtract, an add
    log(f"K7 {name}: table {tuple(table.shape)} at {idx.numel()} indices, bit-exact "
        f"vs plain, max rel vs table[idx] {rel:.3g}; kernel {ms:.4f} ms (median of "
        f"{KERNEL_REPS}), table[idx] {lib_ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {b[0]:.4f} ms by {b[1]}")
    return ms, plain_ms, lib_ms, b


def phase_k7(tables_pk, prim_idx, dev):
    """13. K7 at the main path's shapes -> (ms, plain_ms, library_ms, bound)
    of the triangle-table gather."""
    idx = prim_idx.clamp_min(0).to(torch.int32).contiguous()
    tri = tables_pk.tri_table.contiguous()
    out = check_k7("triangle rows at the primary hits", tri, idx)
    mat_id = fetch_tri(tri, idx).mat_id.to(torch.int32).contiguous()
    check_k7("material rows at the primary hits", tables_pk.mat_table.contiguous(), mat_id)
    gen = torch.Generator(device=dev).manual_seed(13)
    big = torch.rand((11_000, 44), generator=gen, device=dev) * 16.0 - 8.0
    rnd = torch.randint(0, 11_000, (prim_idx.numel(),), generator=gen, device=dev,
                        dtype=torch.int32)
    check_k7("(11k, 44) at random indices", big, rnd)
    return out


def gradcheck(name, image_of, x0, eps, tol, dev, order_only=False) -> dict:
    """bench.py's run_check on the loss mean(image_of(s)): AD at x0 against
    central FD with step eps. The mean is accumulated in float64 (the
    bench's float32 mean loses several percent of a small FD difference to
    rounding: both are printed, the float64 one is checked)."""
    s = torch.tensor(x0, dtype=torch.float32, device=dev, requires_grad=True)
    image_of(s).double().mean().backward()
    g = float(s.grad)
    with torch.no_grad():
        hi = image_of(torch.tensor(x0 + eps, dtype=torch.float32, device=dev))
        lo = image_of(torch.tensor(x0 - eps, dtype=torch.float32, device=dev))
    fd = float(hi.double().mean() - lo.double().mean()) / (2 * eps)
    fd32 = (float(hi.mean()) - float(lo.mean())) / (2 * eps)
    rel = abs(g - fd) / max(abs(fd), 1e-8)
    if order_only:
        ratio = g / fd if abs(fd) > 1e-10 else float("inf")
        ok = math.isfinite(g) and 0.3 < ratio < 3.0
    else:
        ok = rel < tol
    line = {"metric": f"gradcheck_{name}_rel_err", "value": rel, "grad": g, "fd": fd,
            "fd_f32_mean": fd32, "pass": ok}
    if order_only:
        line["mode"] = "order_only"
    log(json.dumps(line))
    if not ok:
        raise AssertionError(f"gradcheck {name}: AD {g:.6g} vs FD {fd:.6g} (rel {rel:.3g})")
    return line


def phase_gradchecks(scene, tables, dev) -> None:
    """14. bench.py's six gradient checks through render_frame, SVGF off."""
    gh = gw = GRAD_SIZE
    cfg = RenderConfig(width=gw, height=gh, max_tracing_depth=2, enable_svgf=False,
                       compact_frac=0.0, compact_auto=False)
    cam = OrbitCamera(width=gw, height=gh).snapshot(dev)
    st0 = FrameState.initial(gh, gw, dev)
    m, lights = scene.materials, scene.lights

    def image(**parts):
        _, out = render_frame(scene.replace(**parts), cam, st0, cfg, gh, gw,
                              tables=tables)
        return out.pt_color

    def light_pos(dx):
        lp = lights.position
        z = torch.zeros(lp.shape[:1], device=dev)
        return lights.replace(position=lp + torch.stack([dx.expand(lp.shape[:1]), z, z],
                                                        dim=-1))

    t0 = time.perf_counter()
    gradcheck("base_color", lambda s: image(
        materials=m.replace(base_color=torch.abs(m.base_color) * s)), 0.8, 1e-2, 0.05, dev)
    gradcheck("specular", lambda s: image(
        materials=m.replace(specular=torch.full_like(m.specular, 0.5) * s)),
        0.9, 1e-2, 0.05, dev)
    gradcheck("sheen", lambda s: image(
        materials=m.replace(sheen=torch.full_like(m.sheen, 0.5) * s)), 0.9, 1e-2, 0.05, dev)
    gradcheck("light_radiance", lambda s: image(
        lights=lights.replace(radiance=lights.radiance * s)), 0.9, 1e-2, 0.05, dev)
    gradcheck("light_pos_interior", lambda dx: image(lights=light_pos(dx)),
              0.0, 5e-3, 0.0, dev, order_only=True)
    s = torch.tensor(0.9, device=dev, requires_grad=True)
    image(materials=m.replace(roughness=torch.clamp(torch.abs(m.roughness) * s, 0.05, 1.0))
          ).double().mean().backward()
    g2 = float(s.grad)
    ok = math.isfinite(g2) and abs(g2) > 1e-10
    log(json.dumps({"metric": "gradcheck_roughness_d2_ad_sanity", "value": g2,
                    "pass": ok}))
    if not ok:
        raise AssertionError(f"roughness AD sanity: {g2}")
    log(f"gradient checks: 6 at {gw}x{gh}, depth 2, SVGF off, in "
        f"{time.perf_counter() - t0:.2f} s")


def train_grads(scene, cfg, cam, target, size, tracer) -> tuple[float, dict]:
    """One make_train_step step (lr 0) from the perturbed materials ->
    (loss, {field: gradient})."""
    params, rebuild = optimize.split_trainable(scene, device=scene.triangles.p0.device)
    with torch.no_grad():
        params["materials"].base_color.mul_(0.4).add_(0.3)
    init, step = optimize.make_train_step(
        rebuild, cfg, size, size, lambda p: torch.optim.SGD(p, lr=0.0), tracer=tracer)
    state, loss = step(init(params), target, cam, 0)
    return float(loss), {f"{g}.{f.name}": getattr(t, f.name).grad
                         for g, t in state.params.items()
                         for f in dataclasses.fields(t)}


def phase_train(scene, dev) -> dict:
    """15. cmd_train's recovery at W x H, then kernel against plain
    gradients at TRAIN_CHECK_SIZE -> the steps' launches."""
    cfg = RenderConfig(width=W, height=H, max_tracing_depth=2, compact_frac=0.0,
                       compact_auto=False)
    cam = OrbitCamera(width=W, height=H).snapshot(dev)
    params, rebuild = optimize.split_trainable(scene, device=dev)
    with torch.no_grad():
        target = optimize.render_flat(rebuild(params), cam, cfg, H, W, 0)
        params["materials"].base_color.mul_(0.4).add_(0.3)
    # Adam on every leaf, as cmd_train, moves clearcoat_gloss past 1 in one
    # step, where GTR1's denominator rounds to 0 (ROADMAP.md section 3)
    init, step = optimize.make_train_step(
        rebuild, cfg, H, W,
        lambda _: torch.optim.Adam([params["materials"].base_color], lr=1e-2))
    state = init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_launches()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, target, cam, 0)
        losses.append(float(loss))  # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
    run = launches()
    peak = torch.cuda.max_memory_allocated()
    log(f"train steps: {TRAIN_STEPS} at {W}x{H}, depth 2, Adam lr 1e-2 on base_color: losses "
        f"{losses}; step ms {[round(x, 3) for x in step_ms]}, median "
        f"{statistics.median(step_ms):.3f} ms; peak memory "
        f"{peak / 2 ** 30:.3f} GiB ({(peak - base_mem) / 2 ** 30:.3f} GiB above the "
        f"scene and target); launches {run}")
    expect_launches("train steps", run, dict(k1=TRAIN_STEPS, k2=2 * TRAIN_STEPS, k3=0,
                                             k4=0, k5=0, k6=0, k7=0))
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"the training loss does not fall: {losses}")
    for leaf in optimize.parameters(state.params):
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError("a trained parameter is not finite")

    n = TRAIN_CHECK_SIZE
    cfg_s = dataclasses.replace(cfg, width=n, height=n)
    cam_s = OrbitCamera(width=n, height=n).snapshot(dev)
    with torch.no_grad():
        target_s = optimize.render_flat(scene, cam_s, cfg_s, n, n, 0)
    loss_k, g_k = train_grads(scene, cfg_s, cam_s, target_s, n, pt.KERNELS)
    (loss_p, g_p), plain_ms = once_ms(
        lambda: train_grads(scene, cfg_s, cam_s, target_s, n, pt.PLAIN))
    worst = 0.0
    for name, ref in g_p.items():
        got = g_k[name]
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        if not bool(torch.isfinite(got).all()) or err > GRAD_ATOL * scale + 1e-12:
            raise AssertionError(f"train-step gradient {name}: kernels differ from plain "
                                 f"by {err:.3g} (largest |g| {scale:.3g})")
        worst = max(worst, err / scale if scale else 0.0)
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p):
        raise AssertionError(f"train-step loss: kernels {loss_k} vs plain {loss_p}")
    log(f"train-step gradients at {n}x{n}: kernels vs plain tracer, loss "
        f"{loss_k:.9g} vs {loss_p:.9g}, max |diff| / max |g| per field {worst:.3g} (atol "
        f"{GRAD_ATOL} of it); plain step {plain_ms:.1f} ms")
    return run


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
    report = build.build_log or (build.library_path().parent / "build.log").read_text()
    ptxas = ptxas_summary(report)
    for kernel, (regs, stack, spill, shared) in ptxas.items():
        log(f"  ptxas: {kernel}: {regs} registers, {stack} bytes stack frame, "
            f"{spill} bytes spill stores, {shared} bytes shared memory a block")

    log("  sass: FP64 instructions per kernel "
        + json.dumps(fp64_in_sass(build.library_path())))

    def smem(prefix: str) -> dict:
        """{kernel: static shared memory a block} of the kernel or its
        instances (K5 has one per tile shape); none is dynamic."""
        return {k: v[3] for k, v in ptxas.items()
                if k == prefix or k.startswith(prefix + "<")}

    # ---- scene
    t0 = time.perf_counter()
    scene = make_test_scene(subdiv=5, env_width=512, device=dev)
    tables = kt.pack_scene(scene.bvh, scene.triangles)
    torch.cuda.synchronize()
    log(f"scene: {scene.triangles.count} triangles, {scene.bvh.count} nodes, "
        f"host build + upload {time.perf_counter() - t0:.2f} s")
    table_bytes = nbytes(tables.meta, tables.aabb, tables.tverts)

    camera = OrbitCamera(width=W, height=H).snapshot(dev)
    orig, d, px, py = camera_rays(camera, H, W)

    # ---- 1. K1: camera primaries
    t_k, i_k = kt.trace_packets(tables, orig, d, INF, common_origin=True)
    (t_p, i_p), k1_plain_ms = once_ms(
        lambda: kt.trace_packets_plain(tables, orig, d, INF, common_origin=True))
    k1_err = check_closest("K1 primaries", t_k, i_k, t_p, i_p)
    inf_rays = torch.full((d.shape[0],), INF, device=dev)  # a float t_max waits on a copy
    k1_ms = kernel_ms(lambda: kt.trace_packets(tables, orig, d, inf_rays,
                                               common_origin=True))
    work = {}
    kt.trace_packets_plain(tables, orig, d, INF, common_origin=True, stats=work)
    k1_bound = bound(table_bytes + nbytes(orig[:1], d, t_k, i_k) + 4 * d.shape[0],
                     work["box_tests"] * BOX_OPS + work["tri_tests"] * TRI_OPS)
    log(f"K1: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.1f} ms "
        f"({d.shape[0] / k1_ms / 1e3:.1f} Mrays/s); work {work}; "
        f"bound {k1_bound[0]:.4f} ms by {k1_bound[1]}")

    # ---- 2. K2: bounce-0 classes of the same frame, captured from the tracer
    calls = recorded_calls(scene, SLICE, tables, (orig, d, px, py))
    if [c[0] for c in calls] != ["packets", "multi", "multi"]:
        raise AssertionError(f"slice-2 frame traversal calls {[c[0] for c in calls]}")
    _, o2, dirs, tms, ah = calls[1][1]
    ah = tuple(ah)
    if ah != (False, True, True):
        raise AssertionError(f"bounce 0 classes {ah}, expected 3")
    got = kt.trace_multi(tables, o2, dirs, tms, ah)
    ref, k2_plain_ms = once_ms(lambda: kt.trace_multi_plain(tables, o2, dirs, tms, ah))
    k2_err = check_closest("K2 bounce class", got[0][0], got[0][1], *ref[0])
    check_any("K2 env-shadow class", got[1][1], ref[1][1])
    check_any("K2 point-shadow class", got[2][1], ref[2][1])
    k2_ms = kernel_ms(lambda: kt.trace_multi(tables, o2, dirs, tms, ah))
    work = {}
    kt.trace_multi_plain(tables, o2, dirs, tms, ah, stats=work)
    k2_bound = bound(table_bytes + nbytes(o2, *dirs, *tms, *[x for g in got for x in g]),
                     work["box_tests"] * BOX_OPS + work["tri_tests"] * TRI_OPS)
    log(f"K2: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.1f} ms "
        f"(live lanes {int((tms[0] > 0).sum())} of {o2.shape[0]}); work {work}; "
        f"bound {k2_bound[0]:.4f} ms by {k2_bound[1]}")
    phase_k2_vs_k3(tables, o2, dirs, tms, ah, got, k2_ms)

    # ---- 3. K4 on the denoiser's inputs of the 5th moving frame
    _, _, _, _, k4_in = moving_renderer(scene, SLICE, 5)
    k4 = kr.reproject_variance_fused(SLICE, **k4_in)
    k4_ref, k4_plain_ms = once_ms(lambda: kr.reproject_variance_plain(SLICE, **k4_in))
    sky = k4_in["linear_z"] == 1.0
    hl_k, hl_p = k4.history_len, k4_ref.history_len
    n_px = hl_p.numel()
    shares = dict(reprojected=float(((hl_p > 1) & ~sky).float().mean()),
                  restarted=float(((hl_p == 1) & ~sky).float().mean()),
                  **fallback_shares(k4_in, hl_p))
    log(f"K4 inputs (frame 5): shares {shares}")
    if shares["reprojected"] <= 0.0 or shares["fallback"] <= 0.0:
        raise AssertionError("K4 inputs do not exercise both the reprojection and the fallback")
    hl_diff = hl_k != hl_p
    n_hl = int(hl_diff.sum())
    log(f"K4: history_len differs on {n_hl} of {n_px} pixels (validity)")
    if n_hl > MAX_MISMATCH * n_px:
        raise AssertionError(f"K4: validity differs on {n_hl} pixels")
    # a pixel whose validity differs moves the 7x7 fallback around it
    near = torch.nn.functional.max_pool2d(hl_diff.float()[None, None], 7, 1, 3)[0, 0] > 0
    k4_err = check_fields("K4 vs plain", k4, k4_ref, valid=~near)
    k4_ms = kernel_ms(lambda: kr.reproject_variance_fused(SLICE, **k4_in))
    n_fail = int(((hl_p == 1) & ~sky).sum())
    n_fallback = int(((hl_p < 4) & ~sky).sum())
    k4_bound = bound(nbytes(*k4_in.values(), *k4),
                     int((~sky).sum()) * K4_PIXEL_OPS + n_fail * K4_RESCUE_OPS
                     + n_fallback * K4_FALLBACK_OPS)
    log(f"K4: kernel {k4_ms:.4f} ms (one launch; shared memory a block "
        f"{smem('reproject_variance')} bytes), plain {k4_plain_ms:.1f} ms, bound "
        f"{k4_bound[0]:.4f} ms by {k4_bound[1]}")

    # ---- 4. K5: the 5-iteration chain on K4's output
    k5_args = (k4.var_illum, k4.var_variance, k4_in["normal"], k4_in["linear_z"],
               k4_in["fwidth_z"], SLICE)
    (fi, fv), (ti, tv) = ka.atrous_chain(*k5_args)
    ((ri, rv), (rti, rtv)), k5_plain_ms = once_ms(lambda: ka.atrous_chain_plain(*k5_args))
    k5_err = check_fields("K5 vs plain", ChainOut(fi, fv, ti, tv),
                          ChainOut(ri, rv, rti, rtv))
    n_iter = SLICE.num_atrous_iterations
    k5_chain_ms = chain_times(k5_args[:5], SLICE)
    k5_ms = k5_chain_ms[-1]
    k5_bound = bound(nbytes(*k5_args[:5], fi, fv, ti, tv),
                     int((~sky).sum()) * n_iter * K5_PIXEL_OPS)
    log(f"K5: chain of {n_iter} {k5_ms:.4f} ms ({step_increments(k5_chain_ms)} ms; shared "
        f"memory a block {smem('atrous_step')} bytes), plain {k5_plain_ms:.1f} ms, "
        f"bound {k5_bound[0]:.4f} ms by {k5_bound[1]}")

    # ---- 5. the main path: moving-camera frames with SVGF + TAA
    r = Renderer(scene, SLICE)
    cam = OrbitCamera(width=W, height=H)
    for _ in range(2):
        r.step(cam.snapshot())
        cam.rotate(0.5, 0.0)
    torch.cuda.synchronize()
    reset_launches()
    frame_ms, hist_max = [], []
    for _ in range(TIMED_FRAMES):
        cam.rotate(0.5, 0.0)
        t0 = time.perf_counter()
        out = r.step(cam.snapshot())
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        hist_max.append(float(out.svgf.history_len.max()))
    main_launches = launches()
    path_launches = dict(main_launches)
    log(f"SVGF frames: {TIMED_FRAMES} at {W}x{H}, median {statistics.median(frame_ms):.3f} ms, "
        f"max {max(frame_ms):.3f} ms, min {min(frame_ms):.3f} ms, "
        f"coverage {float(out.coverage):.4f}, launches {main_launches}")
    want = dict(k1=TIMED_FRAMES, k2=2 * TIMED_FRAMES, k4=TIMED_FRAMES,
                k5=SLICE.num_atrous_iterations * TIMED_FRAMES)
    expect_launches("SVGF frames", main_launches, dict(want, k3=0, k6=0))
    check_image(out, svgf_on=True)
    if not hist_max[-1] > hist_max[0] > 1.0:
        raise AssertionError(f"history_len does not grow: {hist_max}")
    log(f"history_len max per frame {hist_max[0]:.0f} -> {hist_max[-1]:.0f}")

    # the camera still: the static-camera branch (no K4; K5 still runs)
    reset_launches()
    for _ in range(2):
        out = r.step(cam.snapshot())
    still = launches()
    log(f"still frames: 2, launches {still}")
    if still["k4"] != 0 or still["k5"] != 2 * SLICE.num_atrous_iterations:
        raise AssertionError(f"the still frames did not take the static branch: {still}")
    check_image(out, svgf_on=True)

    # 3 frames through the kernels against the same 3 through the plain versions
    out_k = moving_renderer(scene, SLICE, 3)[2]
    (_, _, out_p, _, _), plain_frames_ms = once_ms(
        lambda: moving_renderer(scene, SLICE_PLAIN, 3, tracer=pt.PLAIN))
    log(f"plain-version frames: 3 in {plain_frames_ms:.1f} ms (set-up included)")
    assert_images_close("SVGF frame 3 final, kernels vs plain", out_k.final, out_p.final)

    # ---- 6. slice 1's path: SVGF off
    r = Renderer(scene, SLICE1)
    cam = OrbitCamera(width=W, height=H)
    for _ in range(2):
        r.step(cam.snapshot())
        cam.rotate(0.5, 0.0)
    torch.cuda.synchronize()
    reset_launches()
    frame1_ms = []
    for _ in range(SLICE1_FRAMES):
        cam.rotate(0.5, 0.0)
        t0 = time.perf_counter()
        out = r.step(cam.snapshot())
        torch.cuda.synchronize()
        frame1_ms.append((time.perf_counter() - t0) * 1e3)
    s1 = launches()
    add_launches(path_launches, s1)
    log(f"SVGF-off frames: {SLICE1_FRAMES} at {W}x{H}, median "
        f"{statistics.median(frame1_ms):.3f} ms, max {max(frame1_ms):.3f} ms, "
        f"min {min(frame1_ms):.3f} ms, launches {s1}")
    expect_launches("SVGF-off frames", s1, dict(k1=SLICE1_FRAMES, k2=2 * SLICE1_FRAMES,
                                                k3=0, k4=0, k5=0, k6=0))
    check_image(out, svgf_on=False)
    cam = OrbitCamera(width=W, height=H, yaw_deg=15.0)
    out_k = Renderer(scene, SLICE1).step(cam.snapshot())
    out_p = Renderer(scene, SLICE1, tracer=pt.PLAIN).step(cam.snapshot())
    assert_images_close("SVGF-off frame, kernels vs plain", out_k.pt_color, out_p.pt_color)

    # ---- 7. the SVGF chain at 1920x1080 on one frame's inputs
    cfg_hd = dataclasses.replace(SLICE, width=1920, height=1080)
    _, _, out_hd, state_hd, in_hd = moving_renderer(scene, cfg_hd, 2)

    def chain_hd():
        return svgf_pipeline(in_hd["color"], in_hd["emission"], in_hd["albedo"],
                             out_hd.gbuffer, state_hd, cfg_hd)

    chain_ms = [once_ms(chain_hd)[1] for _ in range(12)][2:]
    hd = chain_hd()
    if not all(bool(torch.isfinite(x).all()) for x in hd):
        raise AssertionError("1080p SVGF chain output is not finite")
    assert_images_close("1080p chain vs its frame", hd.taa, out_hd.svgf.taa)
    log(f"svgf_chain_ms_moving_1080p: median {statistics.median(chain_ms):.3f} ms "
        f"of {len(chain_ms)} (min {min(chain_ms):.3f}, max {max(chain_ms):.3f})")

    # ---- 8. K6 on the 131k forest: primaries and bounce-0 classes
    t0 = time.perf_counter()
    large = make_large_scene(n_spheres=25, subdiv=4, env_width=512, device=dev)
    host_s = time.perf_counter() - t0
    forest = pt.pack_traversal(large)
    torch.cuda.synchronize()
    log(f"scene 131k: {large.triangles.count} triangle rows "
        f"({large.bvh.chunk_tris} a chunk), {forest.n_chunks} chunks of "
        f"{forest.chunk_nodes} node rows, host build {host_s:.2f} s, pack + "
        f"upload {time.perf_counter() - t0 - host_s:.2f} s, tables "
        f"{nbytes(forest.meta, forest.aabb, forest.tverts) / 1e6:.2f} MB, records "
        f"{nbytes(forest.nodes, forest.tris) / 1e6:.2f} MB")
    cam_l = OrbitCamera(width=W, height=H, **LARGE_CAM).snapshot(dev)
    rays_l = camera_rays(cam_l, H, W)
    calls = recorded_calls(large, SLICE, forest, rays_l)
    if [c[0] for c in calls] != ["chunked"] * 6:
        raise AssertionError(f"forest frame traversal calls {[c[0] for c in calls]}")
    k6_err, k6_ms, k6_plain_ms, k6_bound = check_class(
        "K6 131k primaries", ktc.trace_chunked, ktc.trace_chunked_plain, forest,
        (rays_l[0][:1], rays_l[1], INF, False, True), any_hit=False)
    walk_ms = {"primaries": k6_ms}
    for (_, args, _), what in zip(calls[1:], ("bounce-0 env shadow", "bounce-0 point shadow",
                                              "bounce-0 bounce ray", "bounce-1 env shadow",
                                              "bounce-1 point shadow")):
        err, walk_ms[what], *_ = check_class(
            f"K6 131k {what}", ktc.trace_chunked, ktc.trace_chunked_plain, forest,
            args[1:], any_hit=args[4])
        k6_err = max(k6_err, err)
    log("K6 131k, the frame's six walks: "
        + ", ".join(f"{k} {v:.4f}" for k, v in walk_ms.items())
        + f"; sum {sum(walk_ms.values()):.4f} ms")

    # ---- 9. K6 on the 524k forest: primaries and the bounce-0 bounce rays
    t0 = time.perf_counter()
    huge = make_large_scene(n_spheres=25, subdiv=5, env_width=512, device=dev)
    host_s = time.perf_counter() - t0
    forest_h = pt.pack_traversal(huge)
    torch.cuda.synchronize()
    log(f"scene 524k: {huge.triangles.count} triangle rows, {forest_h.n_chunks} "
        f"chunks of {forest_h.chunk_nodes} node rows, host build {host_s:.2f} s, "
        f"pack + upload {time.perf_counter() - t0 - host_s:.2f} s, tables "
        f"{nbytes(forest_h.meta, forest_h.aabb, forest_h.tverts) / 1e6:.2f} MB, records "
        f"{nbytes(forest_h.nodes, forest_h.tris) / 1e6:.2f} MB")
    _, k6h_prim_ms, *_ = check_class(
        "K6 524k primaries", ktc.trace_chunked, ktc.trace_chunked_plain, forest_h,
        (rays_l[0][:1], rays_l[1], INF, False, True), any_hit=False)
    calls_h = recorded_calls(huge, SLICE, forest_h, rays_l)
    _, k6h_bounce_ms, *_ = check_class(
        "K6 524k bounce-0 bounce ray", ktc.trace_chunked, ktc.trace_chunked_plain,
        forest_h, calls_h[3][1][1:], any_hit=False)
    log(f"K6 524k: primaries {k6h_prim_ms:.4f} ms, bounce-0 bounce ray "
        f"{k6h_bounce_ms:.4f} ms")
    del huge, forest_h, calls_h

    # ---- 10. slice 3's main path: moving SVGF frames on the 131k forest
    r = Renderer(large, SLICE)
    cam = OrbitCamera(width=W, height=H, **LARGE_CAM)
    for _ in range(2):
        r.step(cam.snapshot())
        cam.rotate(0.5, 0.0)
    yaw0 = cam.yaw_deg
    forest_ms, run, out = timed_frames(r, cam, TIMED_FRAMES)
    add_launches(path_launches, run)
    log(f"131k forest SVGF frames: {TIMED_FRAMES} at {W}x{H} (OrbitCamera radius "
        f"{LARGE_CAM['radius']}, pitch {cam.pitch_deg}, yaw {yaw0 + 0.5:.1f} to "
        f"{cam.yaw_deg:.1f}), median "
        f"{statistics.median(forest_ms):.3f} ms, max {max(forest_ms):.3f} ms, min "
        f"{min(forest_ms):.3f} ms, coverage {float(out.coverage):.4f}, launches {run}")
    expect_launches("131k forest frames", run, dict(
        k1=0, k2=0, k3=0, k6=6 * TIMED_FRAMES, k4=TIMED_FRAMES,
        k5=SLICE.num_atrous_iterations * TIMED_FRAMES))
    check_image(out, svgf_on=True)
    cfg_s = dataclasses.replace(SLICE, width=FOREST_CHECK_SIZE, height=FOREST_CHECK_SIZE)
    out_k = moving_renderer(large, cfg_s, 2, **LARGE_CAM)[2]
    (_, _, out_p, _, _), plain_frames_ms = once_ms(lambda: moving_renderer(
        large, dataclasses.replace(cfg_s, pallas_denoise=False), 2, tracer=pt.PLAIN,
        **LARGE_CAM))
    log(f"131k plain-version frames: 2 at {FOREST_CHECK_SIZE}x{FOREST_CHECK_SIZE} in "
        f"{plain_frames_ms:.1f} ms (set-up included)")
    assert_images_close("131k frame 2 final, kernels vs plain", out_k.final, out_p.final)
    check_image(out_k, svgf_on=True)
    del r, large, forest, calls

    # ---- 11. K3: bounce-0 env-shadow and continuation rays of paths 2 and 3
    rays = (orig, d, px, py)
    sep_calls = recorded_calls(scene, SEPARATE, tables, rays)
    mis_calls = recorded_calls(scene, MIS, tables, rays)
    for name, c in (("separate-walk", sep_calls), ("MIS", mis_calls)):
        if [x[0] for x in c] != ["packets"] + ["batched"] * 5:
            raise AssertionError(f"{name} frame traversal calls {[x[0] for x in c]}")
    k3_err, k3_ms, k3_plain_ms, k3_bound = check_class(
        "K3 separate-walk bounce-0 bounce ray", kt.trace_batched,
        kt.trace_packets_plain, tables, sep_calls[3][1][1:], any_hit=False)
    for (_, args, _), what in ((sep_calls[1], "separate-walk bounce-0 env shadow"),
                               (mis_calls[1], "MIS bounce-0 light shadow"),
                               (mis_calls[2], "MIS bounce-0 BSDF continuation")):
        err, *_ = check_class(f"K3 {what}", kt.trace_batched, kt.trace_packets_plain,
                              tables, args[1:], any_hit=args[4])
        k3_err = max(k3_err, err)
    del sep_calls, mis_calls

    # ---- 12. MIS and separate-walk frames at 800x800
    for name, cfg in (("MIS", MIS), ("separate-walk", SEPARATE)):
        r = Renderer(scene, cfg)
        cam = OrbitCamera(width=W, height=H)
        for _ in range(2):
            r.step(cam.snapshot())
            cam.rotate(0.5, 0.0)
        ms, run, out = timed_frames(r, cam, SLICE3_FRAMES)
        add_launches(path_launches, run)
        log(f"{name} SVGF frames: {SLICE3_FRAMES} at {W}x{H}, median "
            f"{statistics.median(ms):.3f} ms, max {max(ms):.3f} ms, min "
            f"{min(ms):.3f} ms, coverage {float(out.coverage):.4f}, launches {run}")
        expect_launches(f"{name} frames", run, dict(
            k1=SLICE3_FRAMES, k2=0, k3=5 * SLICE3_FRAMES, k6=0, k4=SLICE3_FRAMES,
            k5=cfg.num_atrous_iterations * SLICE3_FRAMES))
        check_image(out, svgf_on=True)
        out_k = moving_renderer(scene, cfg, 2)[2]
        (_, _, out_p, _, _), plain_frames_ms = once_ms(lambda: moving_renderer(
            scene, dataclasses.replace(cfg, pallas_denoise=False), 2, tracer=pt.PLAIN))
        log(f"{name} plain-version frames: 2 in {plain_frames_ms:.1f} ms (set-up included)")
        assert_images_close(f"{name} frame 2 final, kernels vs plain", out_k.final,
                            out_p.final)
        del r

    # ---- 13. K7 at the main path's shapes (no path calls it)
    k7_ms, k7_plain_ms, k7_lib_ms, k7_bound = phase_k7(pack_scene_tables(scene), i_k, dev)

    # ---- 14. the gradient checks, SVGF off
    phase_gradchecks(scene, tables, dev)

    # ---- 15. the trainer at 800x800
    add_launches(path_launches, phase_train(scene, dev))

    def entry(name, source, replaces, key, err, ms, plain_ms, b, library_ms=None):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=path_launches[key], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                    library_ms=library_ms)

    kernels = [
        entry("K1 trace_packets", "tpuray_torch/csrc/trace.cu",
              "tpuray/kernels/trace_pallas.py:233", "k1", k1_err, k1_ms, k1_plain_ms,
              k1_bound),
        entry("K2 trace_multi", "tpuray_torch/csrc/trace.cu",
              "tpuray/kernels/trace_pallas.py:416", "k2", k2_err, k2_ms, k2_plain_ms,
              k2_bound),
        entry("K3 trace_batched", "tpuray_torch/csrc/trace.cu",
              "tpuray/kernels/trace_pallas.py:67", "k3", k3_err, k3_ms, k3_plain_ms,
              k3_bound),
        entry("K4 reproject_variance_fused", "tpuray_torch/csrc/reproject.cu",
              "tpuray/kernels/reproject_pallas.py:94", "k4", k4_err, k4_ms,
              k4_plain_ms, k4_bound),
        entry("K5 atrous_chain", "tpuray_torch/csrc/atrous.cu",
              "tpuray/kernels/atrous_pallas.py:99", "k5", k5_err, k5_ms, k5_plain_ms,
              k5_bound),
        entry("K6 trace_chunked", "tpuray_torch/csrc/trace_chunked.cu",
              "tpuray/kernels/trace_chunked.py:66", "k6", k6_err, k6_ms, k6_plain_ms,
              k6_bound),
        entry("K7 onehot_gather", "tpuray_torch/csrc/gather.cu",
              "tpuray/kernels/gather_pallas.py:56", "k7", 0.0, k7_ms, k7_plain_ms,
              k7_bound, library_ms=k7_lib_ms),
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
