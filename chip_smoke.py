#!/usr/bin/env python3
"""Smoke run of tpuray_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc (one process per source) and
prints each kernel's registers, stack frame, spill stores and shared memory
a block (ptxas -v; every kernel's shared memory is static) and the FP64
instructions in its SASS (cuobjdump -sass), then:
  1. K1 (trace_packets, the warp walk) on the 640,000 camera primaries of
     an 800x800 frame of the 20,482-triangle test scene, against its plain
     PyTorch version, timed with the float t_max the frame passes; then on
     K1's two other ray sets (traversal_times.k1_rays: a view low over the
     ground, and random directions from one origin), each against its
     plain version and timed;
  2. K2 (trace_multi) on that frame's bounce-0 classes (bounce ray, env
     shadow, point shadow), against its plain version, then each class
     against K3 (trace_batched) on that class alone, with the three K3
     times beside K2's;
  3. K4 (reproject_variance_fused) on the denoiser's inputs of the 5th frame
     of a moving 800x800 Renderer, against its plain version, with the
     inputs' shares of sky and fallback pixels and of blocks with a
     fallback pixel;
 3b. K4 under reproject_gather="tiled" (the TPU kernel's function: the
     tile-windowed read in its 32 x 128 tiles) and under fast_reproject=True
     (the shifted rescue), each on phase 3's inputs and on the same inputs
     with the motion torn (the right half's history 20 rows and 11 columns
     off, a block of random motion): one launch a call, history_len equal
     to the plain version's, every field within rtol 1e-5 / atol 1e-6;
     each tap's resolved share, and K4's ms under each read beside the
     exact instance's (the tiled read's window offsets, torch ops, apart);
     then 3 moving frames of a Renderer under each read (K1 1, K2 2, K4 1,
     K5 5 a frame);
  4. K5 (atrous_step, a chain of 5 iterations) on K4's output, against its plain
     version, timed at 1 to 5 iterations: each step's time beside the
     chain's;
 4b. K4 and each K5 iteration with the row window of a sharded frame's
     rank (atrous_step: one iteration), 2 and 4 shards emulated in this
     process on phase 3's buffers (NCCL puts one rank on a card, and a world
     of one takes the whole image): each shard's rows cut from the full
     image extended by the stage's reach (K4 the halo 32 + 3, K5 2 * step +
     1; the image's edge rows replicated, as the halo exchange gives the
     first and last rank), the kernel run with the shard's window, cropped
     and stitched; held against the plain versions under the same windows
     (validity equal, rtol 1e-5 / atol 1e-6) and against the whole-image
     kernels (phase 3's history taps lie inside the halo: K4 exact, K5
     within rtol 1e-5); the launches, and each kernel's ms on one shard's
     rows with and without the window; then K4 under the tiled read at 2
     and 4 shards (tpuray's sharded read: 40 x 160 tiles from the first
     row of the shard extended by the halo 32, as svgf_pipeline runs it)
     against its plain version (history_len equal) and its ms on one shard;
 4c. the TAA kernel (kernels/taa.py) on the TAA inputs of phase 3's frame
     (its modulated image, the TAA history before it, its velocity and
     depth): the whole image moving and with the camera still, and the row
     windows of 2 and 4 shards emulated as in 4b (each shard's rows
     extended by the halo 32, as render_frame_sharded runs TAA), each one
     launch a call and bit-equal to the plain taa (the shards also to the
     whole-image kernel, since the history taps lie inside the halo);
     the kernel's device time beside the plain version's and its bound;
  5. slice 2's path: Renderer under the slice config (SVGF and TAA on, the
     default view), 2 warm-up frames, then 16 moving-camera frames with the
     launch counts set to 0 just before and read just after; checks the
     image and that every kernel ran; then 2 frames with the camera still
     (on the card a still camera is a moving one with zero motion: K4 and
     K5 each frame, as on tpuray's own device); then 3 frames through the
     kernels against the same 3 frames through the plain versions;
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
 11. K3 (trace_batched, the wide walk) on all five of its walks of one
     frame of the separate-walk (fused_secondary=False) and of the MIS
     integrator on the test scene, each against its plain version and
     timed, with each frame's five-walk sum;
 12. 8 moving MIS frames and 8 moving separate-walk frames at 800x800
     (launches: K1 1 and K3 5 a frame each), and 2 frames of each through
     the kernels against the plain versions;
 13. K7 (onehot_gather, on no path) at the main path's shapes: the
     triangle table (20,482 x 26) at the 640,000 clamped primary hit
     indices of phase 1, the material table at those hits' mat_id, and an
     (11k, 44) table at 640k random indices (traversal_times.k7_cases);
     bit-exact against its plain version, within 2^-16 relative of
     table[idx] (the library yardstick); K7 and table[idx] both timed as
     device work (kernel_ms);
 14. the JAX package's six gradient checks (bench.py:307-434) through the
     port's bench (bench.gradcheck_lines): render_frame with SVGF off,
     128x128, depth 2, compaction on (the residual pass runs: K1 1, K2 2
     or 4 a render): central FD against AD for base_color, specular,
     sheen and light_radiance (relative error < 0.05), light_pos_interior
     (order only, ratio in (0.3, 3)) and the roughness AD sanity (finite,
     |g| > 1e-10);
 15. the trainer (cli/main.py:cmd_train's recovery) at 800x800, depth 2:
     the target from render_flat, base_color * 0.4 + 0.3, then 5
     make_train_step steps (every material and light field differentiated,
     Adam with lr 1e-2 on base_color, the perturbed field) with the launch
     counts set to 0 just before and read just after (K1 1 and K2 2 a
     step); the loss must fall; then one step's gradients through the
     kernels against the plain tracer's at 256x256 (train_check);
 16. the default RenderConfig (compaction on, its budget buckets chosen by
     the Renderer) at 800x800 on the test scene loaded from files: written
     as an OBJ with non-constant texture coordinates under build/, loaded by
     build_scene with procedural textures, the -1 material sentinels and the
     4 point lights of reference_default_scene (profile_frames.file_scene).
     Twice: at subdiv 5 (20,482 triangles: a chunked forest by the layout
     rule, K6) and at subdiv 4 (5,122: a single tree, K1 and K2). Each: 2
     warm-up frames, then 32 moving frames across the first bucket switch
     with the launch counts set to 0 just before and read just after (a
     frame whose hits overflow its budget adds the residual pass's walks);
     the wait of the frame's one host read (the hit count); on the single
     tree, K2 on the compacted bounce-0 rays against its plain version and
     timed beside K2 on the uncompacted ones; 2 frames at the visited
     bucket through the kernels against the plain versions; the compacted
     frame against the same frame with compact_frac=0 (mismatching pixels,
     max |diff|); then wall ms (min, median, max), device ms and kernels a
     frame and the device's busy share with compaction on and off
     (profile_frames.FrameRun, torch.profiler); then the test scene itself
     under RenderConfig(): 53% of its lanes hit, so the first bucket (0.5)
     overflows and the residual pass runs (K2 4 a frame) until the
     Renderer turns compaction off after frame 16 (K2 2);
 17. `python -m tpuray_torch.cli.main render --frames 4 --size 800` as a
     subprocess (the default config on the procedural scene): it must exit
     0 and write a finite 800x800 PNG;
 18. the distribution layer on one NCCL rank (a process group of one from
     a file store under build/; NCCL puts one rank on a card, so this is
     the edge-replicating halo branch and collectives of one): 6 moving
     800x800 frames of render_frame_sharded under the slice config's
     denoiser with the launch counts set to 0 just before and read just
     after (K1 1, K2 2 a frame, or 4 with the residual pass; K4 1 and K5
     5 a frame), bit-equal to render_frame at compact_frac 0 (final and
     history_len), also under reproject_gather="tiled" and under
     fast_reproject=True (K4's tiled and fast rules, K4 1 and K5 5 a
     frame), within the image tolerance at compact_frac 0.5; one
     sharded frame of the 20k file scene (a forest: K6 6 a frame, 11 with
     the residual pass; K4 1, K5 5) against render_frame; render_tiled at 800x800 bit-equal to trace_paths on the
     same row-major rays (K1 1, K2 2), and K1 timed on those rays beside
     the frame's tile-ordered ones; 2 sharded train steps at 800x800,
     depth 2, against make_train_step's (losses within rtol 1e-5, the last
     gradients within GRAD_ATOL of each field's largest, base_color within
     DIST_PARAM_ATOL); run_elastic over 5 card frames with a CUDA fault
     injected before frame 3, bit-equal to an uninterrupted run with one
     restore; `render --elastic` through the CLI; then the wall median,
     device ms and busy share of render_frame (K4, K5), render_frame with
     the plain denoiser, render_frame_sharded (a world of one: render_frame's
     stages on the row-major trace, no halo exchange) with K4 and K5 and
     with the plain stages, in one call.
 19. the viewer (viewer/server.py) on the card: ViewerServer on the 5k file
     scene under RenderConfig(width=400, height=400), 30 frames long-polled
     over loopback with no event (each PNG 400x400 and finite), then a
     param event num_atrous_iterations=3 (K5 3 a frame from the next frame,
     frame_idx back at 0), sigma_l=2.5 (in the config the frames render
     with), a rotate and a view switch; every frame's launches checked
     exactly (K1 1, K2 2 a bounce and again with the residual pass, K4 1,
     K5 an iteration, TAA 1; no frame takes the static-camera branch) from a log
     of the Renderer's render_frame calls; the 30th quiet frame's final
     bit-equal to a direct Renderer's after as many steps; the same frames
     replayed through the plain versions (plain tracer, pallas_denoise
     off): the 30th quiet frame and the last frame with 3 iterations before
     sigma_l against the server's, within the image tolerance of phase 16;
     the viewer's own ms a frame
     and a client's fps at 400x400 and 800x800 under RenderConfig(); then
     `python -m tpuray_torch.cli.main view --port 0` as a subprocess: its
     URL line, /, /state, 3 frames, and exit 0 within 30 s of SIGINT;
 20. `train` through the CLI as a subprocess at its defaults (64x64, depth
     1, 20 steps, lr 0.05) and at 256x256, depth 2, 5 steps: exit 0, both
     PNGs, finite losses, at the defaults the final loss below the first
     (at 256x256 Adam at lr 0.05 overshoots, in tpuray too); then the
     second run in this process with each step timed and its launches
     counted (K1 1, K2 a bounce, again with the residual pass); then the
     first step of that run's scene and config (the procedural scene, the
     default compaction) through the kernels against the plain tracer: the
     loss and every field's gradient (train_check);
 21. the native host library (io/native.py, g++; it must load on the
     card's machine): the 20k file scene's OBJ, the repository's HDR (read
     and write), a BMP and two env caches against their numpy copies; the
     BVH of the 20k scene and of each of the 131k forest's 16 chunks
     against build_bvh_py (first_tri, tri_count, skip equal, boxes within
     1e-6, each leaf the same triangles; perm positions that tied
     centroids order differently counted); set-up seconds native against
     numpy for the 20k file scene and the 131k forest; K1 and K2 on a
     moving 800x800 frame of the native-built 5k file scene, t bit-equal to
     their plain versions;
 22. `python -m tpuray_torch.cli.main bench` as a subprocess with
     BENCH_FULL=1 (tpuray_torch/bench.py): exit 0, one stdout line (the
     headline, trace_rays_per_second), every stderr JSON line parses,
     every metric of bench.py present without an error, every gradient
     check passed, bench_total_s last, and each metric's launches as its
     runs must make them (K1 121 for the headline, K3 25, K6 25 for each
     forest, the SVGF chain K4 16, K5 80 and TAA 16; the frames K1, K2,
     K4, K5 and TAA, the gradient checks K1 and K2); then the bench's own inputs rebuilt
     from its functions: K1 on its primaries, K3 on its incoherent rays
     and K6 on its primaries through phases 8's and 9's 131k and 524k
     forests, each against its plain version and timed as device work
     beside the bench's rate a call (host clock); on the 1080p chain's
     random inputs K4 and each K5 iteration against their plain versions
     and the chain against the plain denoiser, the TAA kernel on the
     chain's own TAA inputs bit-equal to the plain taa (as in 4c), the
     chain's device time beside its ms a call, each stage's device time (K4, K5, modulate, TAA), and one
     call under torch.profiler queued ahead of the device (the kernels' own
     time and span against the events' span, the gaps between kernels,
     memcpy/memset and host syncs). Phase 14 also holds the K1 and K2
     calls of one frame at the gradient checks' 128x128 and config against
     their plain versions.
Any failed check raises (non-zero exit). The last lines are the kernels'
JSON line (launches: the sum over every path run above, each run counted
from 0 just before it, the sharded paths of phase 18, the viewer's and
train's of phases 19 and 20, the gradient checks of phase 14 and the
bench's runs of phase 22 included; errors,
times and bounds from phases 1-4, 4c, 8, 11 and 13), the card's name and power limit, then {"ok": true, "device": {...}}.
Needs no network and no jax. Exits non-zero without a CUDA device.
"""
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch
import torch.distributed as dist

from tpuray_torch.denoise.atrous import atrous_iteration
from tpuray_torch.denoise.modulate import modulate
from tpuray_torch.denoise.svgf import reproject_inputs, svgf_pipeline
from tpuray_torch.denoise.taa import taa
from tpuray_torch.dist import multihost
from tpuray_torch.dist.frame import render_frame_sharded, shard_state
from tpuray_torch.dist.sharding import gather_rows, render_tiled
from tpuray_torch.integrator.gather_tables import pack_scene_tables
from tpuray_torch.integrator import path_tracer as pt
from tpuray_torch.integrator.intersect import INF
from tpuray_torch import bench
from tpuray_torch.kernels import atrous as ka
from tpuray_torch.kernels import build
from tpuray_torch.kernels import gather as kg
from tpuray_torch.kernels import reproject as kr
from tpuray_torch.kernels import taa as ktaa
from tpuray_torch.kernels import trace as kt
from tpuray_torch.kernels import trace_chunked as ktc
from tpuray_torch.kernels import launches, reset_launches
from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.render.renderer import Renderer, camera_rays, render_frame, tonemap
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.procedural import make_large_scene, make_test_scene
from tpuray_torch.train import optimize
from tpuray_torch.denoise_times import (
    chain_times, fallback_shares, moving_renderer, step_increments)
from tpuray_torch.io import native
from tpuray_torch.io.image import read_png
from tpuray_torch.profile_frames import (
    SESSION_PAD, FrameRun, ShardedRun, file_scene, profiled)
from tpuray_torch.traversal_times import (
    k1_rays, k3_walks, k7_cases, kernel_ms, recorded_calls)
from tpuray_torch.utils.elastic import run_elastic

H = W = 800
# slice 2: the default view (SVGF + TAA on) without compaction; phase 16 runs
# RenderConfig() as it is
SLICE = RenderConfig(width=W, height=H, compact_frac=0.0, compact_auto=False)
SLICE_PLAIN = dataclasses.replace(SLICE, pallas_denoise=False)
SLICE1 = dataclasses.replace(SLICE, enable_svgf=False)  # slice 1: SVGF off
TILED = dataclasses.replace(SLICE, reproject_gather="tiled")  # the tile-windowed read
FAST = dataclasses.replace(SLICE, fast_reproject=True)  # the shifted rescue
SEPARATE = dataclasses.replace(SLICE, fused_secondary=False)  # slice 3, path 2
MIS = dataclasses.replace(SLICE, integrator="mis")  # slice 3, path 3
TIMED_FRAMES = 16
READ_FRAMES = 3  # phase 3b's Renderer frames under each history read
SLICE1_FRAMES = 8
SLICE3_FRAMES = 8  # MIS and separate-walk frames
FOREST_CHECK_SIZE = 256  # forest frames against the plain versions
LARGE_CAM = dict(radius=4.0)  # sees the sphere field (tests/test_partition.py)
KERNEL_REPS = 20
TRAIN_STEPS = 5     # the trainer at W x H
TRAIN_CHECK_SIZE = 256  # train-step gradients, kernels against plain
GRAD_ATOL = 1e-4    # of each field's largest |gradient|: table[idx]'s backward sums with atomics
DEFAULT = RenderConfig(width=W, height=H)  # phase 16: every other option at its default
SWITCH_FRAMES = 32  # phase 16's counted frames: the first bucket switch comes after 16
PROFILE_FRAMES = 8  # phase 16's frames under torch.profiler, compaction on and off
MAX_MISMATCH = 1e-4  # idx / hit-miss / validity may differ on <= 0.01%
RTOL, ATOL = 1e-5, 1e-6  # K4 and K5 against their plain versions
ROW_SHARDS = (2, 4)     # phase 4b: the shards emulated in one process
ROW_HALO = 32           # render_frame_sharded's default halo
DIST_FRAMES = 6         # phase 18's moving sharded frames, each config
DIST_COMPACT = 0.5      # the default budget, held fixed (the sharded frame has no tuner)
DIST_TRAIN_STEPS = 2    # sharded train steps against make_train_step's
DIST_PARAM_ATOL = 1e-4  # their base_color after the steps (an Adam step is ~1e-2)
DIST_ELASTIC_FRAMES = 5  # run_elastic's frames, a fault injected before frame 3
# the frames of the timing runs: a plain-denoiser frame issues ~19,000
# kernels, which the profiler takes seconds a frame to digest
DIST_TIMED_FRAMES, DIST_PROFILE_FRAMES = 8, 1

VIEW_SIZE = 400         # phase 19: the viewer's default size
VIEW_FRAMES = 30        # phase 19's long-polled frames with no event
VIEW_TIMED_FRAMES = 40  # phase 19's frames for ms and fps, at 400 and 800
TRAIN_CLI = (["--size", "256", "--depth", "2", "--steps", "5"])  # phase 20's second run

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
# TAA, a non-sky pixel: closest velocity 9 compares, uv 10, 4 history taps
# 30, the history's tonemap and YCoCg-R 12, the 3x3 moments 81, clip_aabb
# 36, two untonemaps 28, the blend 10, its own tile point's transform 12
TAA_PIXEL_OPS = 228


class ChainOut(NamedTuple):  # K5's outputs, for check_fields
    illum: torch.Tensor
    variance: torch.Tensor
    tap_illum: torch.Tensor
    tap_variance: torch.Tensor


class StepOut(NamedTuple):  # one K5 iteration's outputs, for check_fields
    illum: torch.Tensor
    variance: torch.Tensor


def log(msg: str) -> None:
    print(msg, flush=True)


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


def check_k4(name, cfg, k4_in):
    """K4 against its plain version on k4_in (svgf.reproject_inputs): the
    validity (history_len) may differ on at most MAX_MISMATCH of the pixels,
    and every field agrees within RTOL / ATOL away from the 7x7
    neighbourhoods of those pixels -> (kernel output, plain output, the
    pixel shares of each branch, max |diff|, plain ms)."""
    k4 = kr.reproject_variance_fused(cfg, **k4_in)
    k4_ref, plain_ms = once_ms(lambda: kr.reproject_variance_plain(cfg, **k4_in))
    sky = k4_in["linear_z"] == 1.0
    hl_p = k4_ref.history_len
    shares = dict(reprojected=float(((hl_p > 1) & ~sky).float().mean()),
                  restarted=float(((hl_p == 1) & ~sky).float().mean()),
                  **fallback_shares(k4_in, hl_p))
    log(f"{name} inputs: shares {shares}")
    hl_diff = k4.history_len != hl_p
    n_hl, n_px = int(hl_diff.sum()), hl_p.numel()
    log(f"{name}: history_len differs on {n_hl} of {n_px} pixels (validity)")
    if n_hl > MAX_MISMATCH * n_px:
        raise AssertionError(f"{name}: validity differs on {n_hl} pixels")
    # a pixel whose validity differs moves the 7x7 fallback around it
    near = torch.nn.functional.max_pool2d(hl_diff.float()[None, None], 7, 1, 3)[0, 0] > 0
    err = check_fields(f"{name} vs plain", k4, k4_ref, valid=~near)
    return k4, k4_ref, shares, err, plain_ms


def check_k5_iterations(name, k5_args, cfg) -> float:
    """Each iteration of K5's chain against the plain chain's: the chain cut
    to i + 1 iterations for each i (its last output and its tap) -> max
    |diff|."""
    err = 0.0
    for i in range(cfg.num_atrous_iterations):
        c = dataclasses.replace(cfg, num_atrous_iterations=i + 1)
        (fi, fv), (ti, tv) = ka.chain(ka.atrous_step, *k5_args, c)
        (ri, rv), (rti, rtv) = ka.chain(atrous_iteration, *k5_args, c)
        err = max(err, check_fields(f"{name} iteration {i} (step {1 << i})",
                                    ChainOut(fi, fv, ti, tv), ChainOut(ri, rv, rti, rtv)))
    return err


def discontinuous(k4_in: dict) -> dict:
    """Phase 3's inputs with the motion torn: the right half's history 20
    rows up and 11 columns right of where phase 3 has it, and a block of
    per-pixel random motion of up to 16 pixels."""
    m = k4_in["motion"].clone()
    m[:, W // 2:, 0] -= 11.0 / W
    m[:, W // 2:, 1] += 20.0 / H
    g = torch.Generator(device=m.device).manual_seed(5)
    m[300:420, 200:520] = (torch.rand((120, 320, 2), generator=g, device=m.device) - 0.5) \
        * (32.0 / W)
    return dict(k4_in, motion=m.contiguous())


def tap_shares(cfg, k4_in) -> dict:
    """The share of the non-sky pixels at which each tap of the TPU kernel's
    tile-windowed read resolves, each pixel in its own tile's window."""
    from tpuray_torch.denoise import tile_gather as tg
    from tpuray_torch.denoise.reproject import RING, back_project
    t = kr.tiles(cfg, k4_in["motion"], None)
    b = back_project(k4_in["motion"], 0, H, W, cfg)
    iy = torch.arange(H, device=b.y0i.device)[:, None]
    ix = torch.arange(W, device=b.y0i.device)[None, :]
    rg, cg = tg.edge_residuals(b.y0i, b.x0i)
    res = tg.resolve(rg, cg, iy, ix, H, W, t.oy[iy // t.ty, ix // t.tx],
                     t.ox[iy // t.ty, ix // t.tx], RING, t.span)
    live = k4_in["linear_z"] != 1.0
    return {f"{dy},{dx}": round(float(r[0][live].float().mean()), 5)
            for (dy, dx), r in res.items()}


def phase_k4_reads(scene, k4_in: dict, exact_ms: float) -> dict:
    """3b. K4 under the tile-windowed read (the TPU kernel's function) and
    the shifted rescue, each on phase 3's inputs and on their torn motion
    (discontinuous): one launch a call, history_len equal to the plain
    version's and every field within RTOL / ATOL; each tap's resolved share;
    K4's ms under each read beside the exact instance's; then READ_FRAMES
    moving frames of a Renderer under each read (K4 1 and K5 5 a frame).
    -> {read: (max |diff|, ms, plain ms)}"""
    torn = discontinuous(k4_in)
    out = {}
    for read, cfg in (("tiled", TILED), ("fast", FAST)):
        r = Renderer(scene, cfg)
        cam = OrbitCamera(width=W, height=H)
        reset_launches()
        for _ in range(READ_FRAMES):
            cam.rotate(0.5, 0.0)
            frame = r.step(cam.snapshot())
        run = launches()
        expect_launches(f"Renderer, {read} read", run, dict(
            k1=READ_FRAMES, k2=2 * READ_FRAMES, k3=0, k4=READ_FRAMES,
            k5=cfg.num_atrous_iterations * READ_FRAMES, k6=0, k7=0))
        check_image(frame, svgf_on=True)
        log(f"Renderer, {read} read: {READ_FRAMES} moving frames at {W}x{H}, launches {run}, "
            f"history_len max {float(frame.svgf.history_len.max()):.0f}")
        errs = []
        for name, x in (("phase 3", k4_in), ("discontinuous", torn)):
            if read == "tiled":
                log(f"K4 tiled, {name}: resolved share of each tap (dy,dx) "
                    + json.dumps(tap_shares(cfg, x)))
            reset_launches()
            got = kr.reproject_variance_fused(cfg, **x)
            run = launches()
            ref, plain_ms = once_ms(lambda: kr.reproject_variance_plain(cfg, **x))
            if run["k4"] != 1 or not torch.equal(got.history_len, ref.history_len):
                raise AssertionError(f"K4 {read}, {name}: launches {run}, history_len differs "
                                     f"on {int((got.history_len != ref.history_len).sum())}")
            errs.append(check_fields(f"K4 {read}, {name}, vs plain", got, ref))
            sky = x["linear_z"] == 1.0
            hl = ref.history_len
            log(f"K4 {read}, {name}: history_len equal; reprojected "
                f"{float(((hl > 1) & ~sky).float().mean()):.4f}, restarted "
                f"{float(((hl == 1) & ~sky).float().mean()):.4f} of the pixels")
        ms = kernel_ms(lambda: kr.reproject_variance_fused(cfg, **k4_in))
        extra = ""
        if read == "tiled":
            win_ms = kernel_ms(lambda: kr.tiles(cfg, k4_in["motion"], None))
            extra = f" (of which the window offsets' torch ops {win_ms:.4f})"
        log(f"K4 {read}: {ms:.4f} ms{extra} on phase 3's inputs, the exact instance "
            f"{exact_ms:.4f} ms; plain {plain_ms:.1f} ms")
        out[read] = (max(errs), ms, plain_ms)
    return out


def slab(x, row0, rows):
    """Rows row0 .. row0 + rows - 1 of a full-image tensor, its edge rows
    replicated past the image (what dist/frame.py:_halo_rows gives the first
    and the last rank)."""
    idx = torch.clamp(torch.arange(row0, row0 + rows, device=x.device), 0, x.shape[0] - 1)
    return x.index_select(0, idx).contiguous()


def sharded_stage(fn, xs, shards: int, k: int) -> tuple:
    """fn(slabs, (row0, H)) -> a tuple of tensors on each of `shards` row
    shards of the full-image tensors xs (a dict or a list) extended by k rows
    a side, cropped and stitched -> the full-image tuple."""
    rows = H // shards
    parts = []
    for r in range(shards):
        row0 = r * rows - k
        cut = ({n: slab(x, row0, rows + 2 * k) for n, x in xs.items()} if isinstance(xs, dict)
               else [slab(x, row0, rows + 2 * k) for x in xs])
        parts.append(fn(cut, (row0, H)))
    return tuple(torch.cat([part[i][k:-k] for part in parts]) for i in range(len(parts[0])))


def phase_row_window(k4_in: dict, cfg) -> None:
    """4b. K4 and each K5 iteration with the row window of a sharded frame's
    rank, ROW_SHARDS shards emulated in this process on phase 3's buffers
    (NCCL puts one rank on a card, and a world of one takes the whole
    image): each shard's rows cut from the full image extended by the
    stage's reach (K4 ROW_HALO + 3, K5 2 * step + 1; the image's edge rows
    replicated, as _halo_rows does), the kernel run with the shard's window,
    cropped and stitched. Held (a) against the plain versions under the same
    windows at phases 3's and 4's tolerances (validity equal), (b) against
    the whole-image kernels on the same buffers, where every history tap lies
    inside the halo: K4 exact, K5 within RTOL. Prints the launches and
    each kernel's ms on one shard's rows with and without the window."""
    # the farthest row a pixel's bilinear and rescue taps read
    reach = float(k4_in["motion"][..., 1].abs().max()) * H + 3.0
    log(f"row window: the history taps lie within {reach:.2f} rows of their pixel "
        f"(halo {ROW_HALO})")
    if reach >= ROW_HALO:
        raise AssertionError("phase 3's motion leaves the halo: (b) cannot hold")
    kk = ROW_HALO + 3
    whole = kr.reproject_variance_fused(cfg, **k4_in)
    g_in = [k4_in["normal"], k4_in["linear_z"], k4_in["fwidth_z"]]
    for n in ROW_SHARDS:
        reset_launches()
        got = kr.FusedOutput(*sharded_stage(
            lambda s, win: kr.reproject_variance_fused(cfg, row_window=win, **s), k4_in, n, kk))
        run = launches()
        ref = kr.FusedOutput(*sharded_stage(
            lambda s, win: kr.reproject_variance_plain(cfg, row_window=win, **s), k4_in, n, kk))
        if not torch.equal(got.history_len, ref.history_len):
            raise AssertionError(f"K4, {n} shards: the validity differs from the plain version")
        err = check_fields(f"K4, {n} shards, vs plain under the same windows", got, ref)
        same = [f for f in got._fields if torch.equal(getattr(got, f), getattr(whole, f))]
        d = max(float((getattr(got, f) - getattr(whole, f)).abs().max()) for f in got._fields)
        log(f"K4, {n} shards of {H // n} rows extended by {kk}: launches {run}; vs plain "
            f"max |diff| {err:.3g}; vs the whole-image K4 max |diff| {d:.3g}, equal fields "
            f"{len(same)} of {len(got._fields)}")
        if run["k4"] != n or len(same) != len(got._fields):
            raise AssertionError(f"K4, {n} shards: launches {run} or not the whole image's")
        illum, var = whole.var_illum, whole.var_variance
        reset_launches()
        errs, diffs = [], []
        for i in range(cfg.num_atrous_iterations):
            step = 1 << i
            ks = 2 * step + 1
            full = ka.atrous_step(illum, var, *g_in, step, cfg)
            got5 = sharded_stage(lambda s, win: ka.atrous_step(*s, step, cfg, row_window=win),
                                 [illum, var, *g_in], n, ks)
            ref5 = sharded_stage(lambda s, win: atrous_iteration(*s, step, cfg, row_window=win),
                                 [illum, var, *g_in], n, ks)
            errs.append(check_fields(f"K5, {n} shards, step {step}, vs plain",
                                     StepOut(*got5), StepOut(*ref5)))
            diffs.append(check_fields(f"K5, {n} shards, step {step}, vs the whole image",
                                      StepOut(*got5), StepOut(*full)))
            illum, var = full
        run = launches()
        log(f"K5, {n} shards: launches {run} (with the whole image's iterations), max |diff| "
            f"vs plain {max(errs):.3g}, vs the whole image per step {diffs}")
        if run["k5"] != (n + 1) * cfg.num_atrous_iterations:
            raise AssertionError(f"K5, {n} shards: launches {run}")
    # the tile-windowed read on the shards, on the rows extended by ROW_HALO
    # (svgf_pipeline's: the read never leaves them)
    for n in ROW_SHARDS:
        reset_launches()
        got = kr.FusedOutput(*sharded_stage(
            lambda s, win: kr.reproject_variance_fused(TILED, row_window=win, **s),
            k4_in, n, ROW_HALO))
        run = launches()
        ref = kr.FusedOutput(*sharded_stage(
            lambda s, win: kr.reproject_variance_plain(TILED, row_window=win, **s),
            k4_in, n, ROW_HALO))
        if run["k4"] != n or not torch.equal(got.history_len, ref.history_len):
            raise AssertionError(f"K4 tiled, {n} shards: launches {run} or the validity "
                                 "differs from the plain version")
        err = check_fields(f"K4 tiled, {n} shards, vs plain under the same windows", got, ref)
        log(f"K4 tiled, {n} shards of {H // n} rows extended by {ROW_HALO}: launches {run}; "
            f"vs plain max |diff| {err:.3g}")
    # one shard's rows (the second of the last split), with and without the window
    n = ROW_SHARDS[-1]
    rows = H // n
    cut = {name: slab(x, rows - kk, rows + 2 * kk) for name, x in k4_in.items()}
    k4_win = kernel_ms(lambda: kr.reproject_variance_fused(cfg, row_window=(rows - kk, H), **cut))
    cut_t = {name: slab(x, rows - ROW_HALO, rows + 2 * ROW_HALO) for name, x in k4_in.items()}
    k4_tiled = kernel_ms(lambda: kr.reproject_variance_fused(
        TILED, row_window=(rows - ROW_HALO, H), **cut_t))
    k4_none = kernel_ms(lambda: kr.reproject_variance_fused(cfg, **cut))
    k4_whole = kernel_ms(lambda: kr.reproject_variance_fused(cfg, **k4_in))
    parts = []
    for i in range(cfg.num_atrous_iterations):
        step = 1 << i
        ks = 2 * step + 1
        cut5 = [slab(x, rows - ks, rows + 2 * ks)
                for x in (whole.var_illum, whole.var_variance, *g_in)]
        parts.append((kernel_ms(lambda: ka.atrous_step(*cut5, step, cfg,
                                                       row_window=(rows - ks, H))),
                      kernel_ms(lambda: ka.atrous_step(*cut5, step, cfg))))
    log(f"row window ms (device work), shard 1 of {n} ({rows} rows): K4 on "
        f"{rows + 2 * kk} rows {k4_win:.4f} with the window, {k4_none:.4f} without (the "
        f"whole {H} rows {k4_whole:.4f}), tile-windowed on {rows + 2 * ROW_HALO} rows "
        f"{k4_tiled:.4f}; K5 steps 1..{1 << (cfg.num_atrous_iterations - 1)} "
        f"with / without " + ", ".join(f"{a:.4f} / {b:.4f}" for a, b in parts)
        + f"; sum {sum(a for a, _ in parts):.4f} / {sum(b for _, b in parts):.4f}")


def check_taa(name, args, static: bool = False) -> tuple:
    """The TAA kernel on args (cur_color, prev_color, velocity, linear_z,
    frame): one launch, bit-equal to the plain taa -> (kernel device ms,
    plain ms of one call, the plain version's device ms, bound)."""
    reset_launches()
    got = ktaa.taa(*args, static_camera=static)
    run = launches()
    want, plain_ms = once_ms(lambda: taa(*args, static_camera=static))
    if run["taa"] != 1:
        raise AssertionError(f"TAA {name}: launches {run}")
    if not torch.equal(got, want):
        d = (got - want).abs().amax(-1)
        raise AssertionError(f"TAA {name}: {int((d != 0).sum())} of {d.numel()} pixels "
                             f"differ from the plain taa, the largest by {float(d.max()):.3g}")
    ms = kernel_ms(lambda: ktaa.taa(*args, static_camera=static))
    # one call a reading: the plain taa's ~550 launches overflow the launch queue
    plain_dev = kernel_ms(lambda: taa(*args, static_camera=static), 1)
    b = bound(nbytes(*args[:4], got), int((args[3] != 1.0).sum()) * TAA_PIXEL_OPS)
    log(f"TAA {name}: {tuple(got.shape[:2])}, frame {args[4]}, one launch, bit-equal to "
        f"the plain taa; kernel {ms:.4f} ms (device time, mean of {KERNEL_REPS}), plain "
        f"{plain_dev:.4f} device ms "
        f"({plain_ms:.3f} ms a synchronised call), bound {b[0]:.4f} ms by {b[1]} (the "
        f"kernel at {ms / b[0]:.2f}x it)")
    return ms, plain_ms, plain_dev, b


def phase_taa(out, state) -> tuple:
    """4c. The TAA kernel on the TAA inputs of phase 3's frame (out: its
    outputs, state: the state it started from): the frame's own TAA output
    recomputed, the whole image moving and still, then the row windows of
    ROW_SHARDS shards emulated as in 4b, each shard's rows extended by the
    halo (render_frame_sharded's TAA reach, max(halo, 2)) -> check_taa's
    readings of the moving whole image."""
    args = (out.svgf.modulated, state.taa_color, out.gbuffer.velocity,
            out.gbuffer.linear_z, state.frame_idx)
    whole = ktaa.taa(*args)
    if not torch.equal(whole, out.svgf.taa):
        raise AssertionError("TAA: the kernel on the frame's TAA inputs is not its output")
    result = check_taa(f"{W}x{H} (frame {state.frame_idx})", args)
    check_taa(f"{W}x{H} (frame {state.frame_idx}), camera still", args, static=True)
    # the farthest row a pixel's history taps read
    reach = float(args[2][..., 1].abs().max()) * H + 2.0
    frame, k = args[4], max(ROW_HALO, 2)
    for n in ROW_SHARDS:
        reset_launches()
        (got,) = sharded_stage(lambda s, win: (ktaa.taa(*s, frame, row_window=win),),
                               list(args[:4]), n, k)
        run = launches()
        (ref,) = sharded_stage(lambda s, win: (taa(*s, frame, row_window=win),),
                               list(args[:4]), n, k)
        if run["taa"] != n or not torch.equal(got, ref):
            d = (got - ref).abs().amax(-1)
            raise AssertionError(f"TAA, {n} shards: launches {run}; {int((d != 0).sum())} "
                                 f"pixels differ from the plain taa under the same windows")
        same = torch.equal(got, whole)
        row0 = H // n - k
        one = [slab(x, row0, H // n + 2 * k) for x in args[:4]]
        ms_win = kernel_ms(lambda: ktaa.taa(*one, frame, row_window=(row0, H)))
        ms_own = kernel_ms(lambda: ktaa.taa(*one, frame))
        log(f"TAA, {n} shards of {H // n} rows extended by {k} (history taps within "
            f"{reach:.2f} rows): launches {run}; bit-equal to the plain taa under the same "
            f"windows; the whole image's kernel output {'equal' if same else 'differs'}; "
            f"one shard's rows {ms_win:.4f} ms with the window, {ms_own:.4f} ms without")
        if reach < k and not same:
            raise AssertionError(f"TAA, {n} shards: differs from the whole image's though "
                                 f"every history tap lies inside the halo")
    return result


def check_frame_walks(name, scene, cfg, tables, rays) -> None:
    """Every K1 and K2 call of one frame of trace_paths on rays (as
    recorded_calls gives them, compaction as cfg says) against its plain
    version on the same arguments."""
    calls = recorded_calls(scene, cfg, tables, rays)
    kinds = sorted({n for n, _, _ in calls})
    if kinds != ["multi", "packets"]:
        raise AssertionError(f"{name}: traversal calls {[n for n, _, _ in calls]}")
    for k, (kind, args, _) in enumerate(calls):
        if kind == "packets":
            t_k, i_k = kt.trace_packets(*args)
            t_p, i_p = kt.trace_packets_plain(*args)
            if args[4]:
                check_any(f"{name} K1 call {k}", i_k, i_p)
            else:
                check_closest(f"{name} K1 call {k}", t_k, i_k, t_p, i_p)
            continue
        tables_, o2, dirs, tms, ah = args
        got = kt.trace_multi(tables_, o2, dirs, tms, tuple(ah))
        ref = kt.trace_multi_plain(tables_, o2, dirs, tms, tuple(ah))
        for cls in range(len(dirs)):
            if ah[cls]:
                check_any(f"{name} K2 call {k} class {cls}", got[cls][1], ref[cls][1])
            else:
                check_closest(f"{name} K2 call {k} class {cls}", *got[cls], *ref[cls])
    log(f"{name}: {len(calls)} traversal calls ({', '.join(n for n, _, _ in calls)}) "
        f"agree with their plain versions")


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
    ms = kernel_ms(lambda: kernel(tables, *args), reps)
    work = {}
    plain(tables, *args, stats=work)
    live = int((tm > 0).sum())
    # a float t_max is one argument of the function, not an (N,) input
    per_ray = (args[2],) if isinstance(args[2], torch.Tensor) else ()
    b = trace_bound(tables, work, args[0], args[1], *per_ray, t_k, i_k)
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
        total[k] = total.get(k, 0) + n


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
    ms = kernel_ms(lambda: kg.onehot_gather(table, idx))
    lib_ms = kernel_ms(lambda: table[idx])
    b = bound(nbytes(table, idx, got), got.numel() * 4)  # 2 roundings, a subtract, an add
    log(f"K7 {name}: table {tuple(table.shape)} at {idx.numel()} indices, bit-exact "
        f"vs plain, max rel vs table[idx] {rel:.3g}; kernel {ms:.4f} ms, table[idx] "
        f"{lib_ms:.4f} ms (device time, mean of 20), plain {plain_ms:.3f} ms, bound "
        f"{b[0]:.4f} ms by {b[1]} (the kernel at {ms / b[0]:.2f}x it)")
    return ms, plain_ms, lib_ms, b


def phase_k7(scene, prim_idx):
    """13. K7 at the main path's shapes -> (ms, plain_ms, library_ms, bound)
    of the triangle-table gather."""
    results = [check_k7(name, table, idx) for name, table, idx in k7_cases(scene, prim_idx)]
    return results[0]


def phase_gradchecks(scene, tables, dev) -> dict:
    """14. bench.py's six gradient checks through the bench's own code
    (bench.gradcheck_lines: render_frame with SVGF off, 128x128, depth 2,
    compaction on) -> their launches."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_launches()
    lines = []
    for line in bench.gradcheck_lines(scene, tables, dev):
        log(json.dumps(line))
        if not line["pass"]:
            raise AssertionError(f"{line['metric']}: {line}")
        lines.append(line)
    run = launches()
    renders = 3 * (len(lines) - 1) + 1  # AD and two FD renders a check, AD only for roughness
    log(f"gradient checks: {len(lines)} at {bench.GRAD_SIZE}x{bench.GRAD_SIZE}, depth 2, SVGF off, "
        f"compaction on, in {time.perf_counter() - t0:.2f} s; launches {run}")
    if len(lines) != 6 or not 2 * renders <= run["k2"] <= 4 * renders:
        raise AssertionError(f"gradient checks: {len(lines)} lines, launches {run}")
    expect_launches("gradient checks", run, dict(k1=renders, k3=0, k4=0, k5=0, k6=0, k7=0))
    # K1 and K2 at the checks' size and config, on their camera's rays
    size = bench.GRAD_SIZE
    cam = OrbitCamera(width=size, height=size).snapshot(dev)
    check_frame_walks(f"gradient-check frame {size}x{size}", scene, bench.gradcheck_config(),
                      tables, camera_rays(cam, size, size))
    return run


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
    train_check(scene, dataclasses.replace(cfg, width=n, height=n), dev, "train-step")
    return run


def train_check(scene, cfg, dev, tag: str) -> None:
    """One train step's loss and gradients (train_grads) at cfg's size
    through the kernels against the plain tracer: the loss within rtol
    1e-5, each field's gradient within GRAD_ATOL of its largest |g|."""
    n = cfg.width
    cam = OrbitCamera(width=n, height=n).snapshot(dev)
    with torch.no_grad():
        target = optimize.render_flat(scene, cam, cfg, n, n, 0)
    loss_k, g_k = train_grads(scene, cfg, cam, target, n, pt.KERNELS)
    (loss_p, g_p), plain_ms = once_ms(
        lambda: train_grads(scene, cfg, cam, target, n, pt.PLAIN))
    worst = 0.0
    for name, ref in g_p.items():
        got = g_k[name]
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        if not bool(torch.isfinite(got).all()) or err > GRAD_ATOL * scale + 1e-12:
            raise AssertionError(f"{tag} gradient {name}: kernels differ from plain "
                                 f"by {err:.3g} (largest |g| {scale:.3g})")
        worst = max(worst, err / scale if scale else 0.0)
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p):
        raise AssertionError(f"{tag} loss: kernels {loss_k} vs plain {loss_p}")
    log(f"{tag} gradients at {n}x{n}, depth {cfg.max_tracing_depth}, compact_frac "
        f"{cfg.compact_frac}: kernels vs plain tracer, loss {loss_k:.9g} vs {loss_p:.9g}, "
        f"max |diff| / max |g| per field {worst:.3g} (atol {GRAD_ATOL} of it); plain "
        f"step {plain_ms:.1f} ms")

def _frame_walks(forest: bool, residual: bool) -> dict:
    """The traversal launches of one moving depth-2 NEE frame: a forest
    walks everything through K6 (the primaries and five secondary walks), a
    single tree takes K1 for the primaries and K2 a bounce; the residual
    pass walks its secondaries again."""
    if forest:
        return dict(k1=0, k2=0, k6=6 + (5 if residual else 0))
    return dict(k1=1, k2=2 + (2 if residual else 0), k6=0)


def phase_k2_compacted(scene, tables, bucket: float, dev) -> None:
    """16, single tree: K2 on one frame's compacted bounce-0 rays (budget
    lanes) against its plain version, timed beside K2 on the same frame's
    uncompacted rays."""
    camera = OrbitCamera(width=W, height=H).snapshot(dev)
    rays = camera_rays(camera, H, W)
    cfg = dataclasses.replace(DEFAULT, compact_frac=bucket, compact_auto=False)
    times = {}
    for name, c in (("compacted", cfg), ("uncompacted", dataclasses.replace(cfg, compact_frac=0.0))):
        calls = recorded_calls(scene, c, tables, rays)
        multi = [a for n, a, _ in calls if n == "multi"]
        _, o2, dirs, tms, ah = multi[0]
        got = kt.trace_multi(tables, o2, dirs, tms, tuple(ah))
        ref = kt.trace_multi_plain(tables, o2, dirs, tms, tuple(ah))
        check_closest(f"K2 {name} bounce class", got[0][0], got[0][1], *ref[0])
        for cls in (1, 2):
            check_any(f"K2 {name} shadow class {cls}", got[cls][1], ref[cls][1])
        times[name] = (o2.shape[0], int((tms[0] > 0).sum()), len(multi),
                       kernel_ms(lambda: kt.trace_multi(tables, o2, dirs, tms, tuple(ah))))
    log("K2 under compaction (bounce 0): " + "; ".join(
        f"{k} {n} lanes ({live} live), {calls} K2 calls a frame, {ms:.4f} ms"
        for k, (n, live, calls, ms) in times.items()))


def default_frames(scene, forest: bool, tag: str) -> tuple[dict, object, list]:
    """RenderConfig() as it is: 2 warm-up frames, then SWITCH_FRAMES moving
    frames across the first budget switch with the launch counts set to 0
    just before and read just after, each frame's traversal launches
    expected from its budget and hit count (the residual pass walks the
    secondaries again) -> (launches, last outputs, compact_frac per frame).
    Times the frames and the wait of each frame's one host read."""
    r = Renderer(scene, DEFAULT)
    cam = OrbitCamera(width=W, height=H)
    for _ in range(2):
        r.step(cam.snapshot())
        cam.rotate(0.5, 0.0)
    n = W * H  # 800 is a multiple of the 32-pixel tile: no padding lanes
    waits = []
    host_count = pt.host_count

    def timed_count(count):
        t = time.perf_counter()
        value = host_count(count)
        waits.append((time.perf_counter() - t) * 1e3)
        return value

    want = dict(k1=0, k2=0, k3=0, k4=0, k5=0, k6=0, k7=0)
    buckets, residual, frame_ms = [], [], []
    torch.cuda.synchronize()
    pt.host_count = timed_count
    try:
        reset_launches()
        for _ in range(SWITCH_FRAMES):
            buckets.append(r.frame_cfg.compact_frac)
            budget = pt._compact_budget(n, r.frame_cfg)
            cam.rotate(0.5, 0.0)
            t1 = time.perf_counter()
            out = r.step(cam.snapshot())
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t1) * 1e3)
            residual.append(0 < budget < round(float(out.coverage) * n))
            add_launches(want, dict(_frame_walks(forest, residual[-1]), k4=1,
                                    k5=DEFAULT.num_atrous_iterations))
        run = launches()
    finally:
        pt.host_count = host_count
    switches = [(i, a, b) for i, (a, b) in enumerate(zip(buckets, buckets[1:]), 1) if a != b]
    by_kind = {}
    for ms, frac, res in zip(frame_ms, buckets, residual):
        by_kind.setdefault(f"compact_frac {frac}{' + residual' if res else ''}", []).append(ms)
    log(f"{tag} default-config frames: {SWITCH_FRAMES} at {W}x{H}, median "
        f"{statistics.median(frame_ms):.3f} ms, max {max(frame_ms):.3f} ms, min "
        f"{min(frame_ms):.3f} ms, coverage {float(out.coverage):.4f}; compact_frac per "
        f"frame {buckets} (switches (frame, from, to) {switches}); residual passes "
        f"{sum(residual)}; medians by kind " + ", ".join(
            f"{k} {statistics.median(v):.3f} ms ({len(v)})" for k, v in by_kind.items())
        + (f"; the hit-count read waits median {statistics.median(waits):.3f} ms (max "
           f"{max(waits):.3f}) over {len(waits)} reads" if waits else "")
        + f"; launches {run}")
    expect_launches(f"{tag} frames", run, want)
    if not switches:
        raise AssertionError(f"{tag}: the budget bucket did not switch: {buckets}")
    return run, out, buckets


def phase_file_scene(subdiv: int, dev) -> dict:
    """16. The default config on the test scene loaded from files -> the
    counted frames' launches."""
    t0 = time.perf_counter()
    scene = file_scene(subdiv, device=dev)
    tables = pt.pack_traversal(scene)
    torch.cuda.synchronize()
    forest = bool(tables.chunk_nodes)
    tag = f"file scene {scene.triangles.count}"
    log(f"{tag}: {'a chunked forest of ' + str(tables.n_chunks) + ' chunks' if forest else 'a single tree'} "
        f"({scene.bvh.count} node rows), textures {tuple(scene.textures.data.shape)}, "
        f"materials base_color {scene.materials.base_color.tolist()}, "
        f"{scene.lights.count} point lights; host build + upload "
        f"{time.perf_counter() - t0:.2f} s")
    run, out, buckets = default_frames(scene, forest, tag)
    check_image(out, svgf_on=True)
    bucket = buckets[-1] or DEFAULT.compact_frac
    if not forest:
        phase_k2_compacted(scene, tables, bucket, dev)

    fixed = dataclasses.replace(DEFAULT, compact_frac=bucket, compact_auto=False)
    out_k = moving_renderer(scene, fixed, 2)[2]
    (_, _, out_p, _, _), plain_ms = once_ms(lambda: moving_renderer(
        scene, dataclasses.replace(fixed, pallas_denoise=False), 2, tracer=pt.PLAIN))
    log(f"{tag} plain-version frames: 2 at compact_frac {bucket} in {plain_ms:.1f} ms "
        f"(set-up included)")
    assert_images_close(f"{tag} frame 2 final at compact_frac {bucket}, kernels vs plain",
                        out_k.final, out_p.final)
    out_0 = moving_renderer(scene, dataclasses.replace(fixed, compact_frac=0.0), 2)[2]
    for field in ("pt_color", "final"):
        a, b = getattr(out_k, field), getattr(out_0, field)
        log(f"{tag} frame 2 {field}, compact_frac {bucket} vs 0: "
            f"{int((a != b).any(-1).sum())} of {a.shape[0] * a.shape[1]} pixels differ, "
            f"max |diff| {float((a - b).abs().max()):.3g}")
        assert_images_close(f"{tag} frame 2 {field}, compacted vs uncompacted", a, b)

    runs = [FrameRun(scene, DEFAULT, f"{tag} compaction on"),
            FrameRun(scene, dataclasses.replace(DEFAULT, compact_frac=0.0, compact_auto=False),
                     f"{tag} compaction off")]
    walls = [run.time_frames(TIMED_FRAMES) for run in runs]
    res = [run.profile_frames(PROFILE_FRAMES, wall, Path("build/profile"))
           for run, wall in zip(runs, walls)]
    on, off = res
    log(f"{tag}: compaction on vs off: wall median {on['wall_ms']:.3f} vs {off['wall_ms']:.3f} "
        f"ms, device {on['device_ms_per_frame']:.3f} vs {off['device_ms_per_frame']:.3f} ms a "
        f"frame, {on['kernels_per_frame']:.1f} vs {off['kernels_per_frame']:.1f} kernels a "
        f"frame, busy share {on['busy_share']:.3f} vs {off['busy_share']:.3f}")
    return run


def phase_cli() -> None:
    """17. The CLI's render on the card, as a user runs it."""
    root = Path(__file__).resolve().parent
    png = root / "build" / "cli_render.png"
    png.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "tpuray_torch.cli.main", "render", "--frames", "4",
           "--size", "800", "--out", str(png)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
    log(f"cli: {' '.join(cmd[1:])} -> exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; stderr: {proc.stderr.strip()[-600:]}")
    if proc.returncode != 0:
        raise AssertionError(f"the CLI's render exited {proc.returncode}")
    img = read_png(str(png))
    if img.shape != (H, W, 3) or not bool((img > 0).any()):
        raise AssertionError(f"the CLI wrote an image of shape {img.shape}")


def dist_frames(scene, cfg, mesh, frames: int, still_last: bool = False, **cam_kw):
    """`frames` moving frames of render_frame_sharded (launch counts set to
    0 just before and read just after) and the same frames of render_frame
    -> (sharded finals, single finals, sharded launches, ms per sharded
    frame, last states). still_last: the last frame repeats the camera with
    static_camera=True (K4 at zero motion under the kernel denoiser)."""
    tables, pk = pt.pack_traversal(scene), pack_scene_tables(scene)
    cam = OrbitCamera(width=W, height=H, **cam_kw)
    state = shard_state(FrameState.initial(H, W), mesh)
    finals, ms = [], []
    torch.cuda.synchronize()
    reset_launches()
    with torch.no_grad():
        for i in range(frames):
            still = still_last and i == frames - 1
            cam.rotate(0.0 if still else 0.5, 0.0)
            t0 = time.perf_counter()
            state, final, _ = render_frame_sharded(scene, cam.snapshot(), state, cfg, H, W,
                                                   mesh, static_camera=still, tables=tables,
                                                   pk=pk)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            finals.append(final)
        run = launches()
        cam = OrbitCamera(width=W, height=H, **cam_kw)
        single = FrameState.initial(H, W, mesh.device)
        outs = []
        for i in range(frames):
            still = still_last and i == frames - 1
            cam.rotate(0.0 if still else 0.5, 0.0)
            single, out = render_frame(scene, cam.snapshot(mesh.device), single, cfg, H, W,
                                       tables=tables, pk=pk, static_camera=still)
            outs.append(out)
    return finals, outs, run, ms, (state, single)


def frame_walk_launches(outs, cfg, forest: bool) -> dict:
    """The launches of render_frame_sharded's frames on a world of one: the
    walks from each frame's budget against its hit count (the single-device
    frame's coverage: the same rays, in another order), and K4 once and K5
    once an iteration under the kernel denoiser."""
    want = dict(k1=0, k2=0, k3=0, k4=0, k5=0, k6=0, k7=0)
    budget = pt._compact_budget(W * H, cfg)
    for out in outs:
        add_launches(want, _frame_walks(forest, 0 < budget < round(float(out.coverage) * W * H)))
        if cfg.enable_svgf and cfg.pallas_denoise:
            add_launches(want, dict(k4=1, k5=cfg.num_atrous_iterations))
    return want


def phase_dist(scene, dev) -> tuple[dict, float, float]:
    """18. The distribution layer on one NCCL rank -> (the launches of its
    paths, K1's ms on the sharded path's row-major rays, on the frame's
    tile-ordered rays)."""
    store = Path(__file__).resolve().parent / "build" / "dist_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    multihost.initialize(f"file://{store}", 1, 0, device="cuda")
    try:
        return _phase_dist(scene, dev, multihost.global_mesh())
    finally:
        multihost.shutdown()


def _phase_dist(scene, dev, mesh) -> tuple[dict, float, float]:
    total = dict(k1=0, k2=0, k3=0, k4=0, k5=0, k6=0, k7=0)
    log(f"dist: rank {mesh.rank} of {mesh.size} on {mesh.device}, backend "
        f"{dist.get_backend()} (NCCL puts one rank on a card)")

    # the sharded frame under the slice config's denoiser (K4 and K5 on the
    # rank's rows): bit-equal to render_frame at compact_frac 0, the last
    # frame a still one (static_camera=True), close to it under compaction
    for name, cfg in (("compact_frac 0", SLICE),
                      ("compact_frac 0, tile-windowed read", TILED),
                      ("compact_frac 0, shifted rescue", FAST),
                      (f"compact_frac {DIST_COMPACT}",
                       dataclasses.replace(SLICE, compact_frac=DIST_COMPACT))):
        still = cfg.compact_frac == 0.0
        finals, outs, run, ms, (st, single) = dist_frames(scene, cfg, mesh, DIST_FRAMES,
                                                          still_last=still)
        add_launches(total, run)
        want = frame_walk_launches(outs, cfg, forest=False)
        log(f"sharded frames, {name}: {DIST_FRAMES} at {W}x{H} (moving"
            f"{', the last still' if still else ''}), median "
            f"{statistics.median(ms):.3f} ms, launches {run} (want {want})")
        expect_launches(f"sharded frames, {name}", run, want)
        for i, (a, out) in enumerate(zip(finals, outs)):
            if cfg.compact_frac == 0.0:
                if not (torch.equal(a, out.final) and torch.equal(st.history_len, single.history_len)):
                    raise AssertionError(f"sharded frame {i} differs from render_frame: max "
                                         f"{float((a - out.final).abs().max()):.3g}")
            else:
                assert_images_close(f"sharded frame {i}, {name}, vs render_frame", a, out.final)
        if cfg.compact_frac == 0.0:
            log(f"sharded frames, {name}: all {DIST_FRAMES} final images and the last "
                f"history_len bit-equal to render_frame's")
        check_image(outs[-1], svgf_on=True)

    # the sharded frame on the 20k file scene: a forest, every walk K6
    file20 = file_scene(5, device=dev)
    cfg = dataclasses.replace(DEFAULT, compact_frac=DIST_COMPACT, compact_auto=False)
    finals, outs, run, ms, _ = dist_frames(file20, cfg, mesh, 1)
    add_launches(total, run)
    want = frame_walk_launches(outs, cfg, forest=True)
    log(f"sharded frame, file scene {file20.triangles.count} (a forest), compact_frac "
        f"{DIST_COMPACT}: {ms[0]:.3f} ms, launches {run} (want {want})")
    expect_launches("sharded forest frame", run, want)
    assert_images_close("sharded forest frame vs render_frame", finals[0], outs[0].final)
    del file20

    # render_tiled against trace_paths on the same row-major rays
    cam = OrbitCamera(width=W, height=H).snapshot(dev)
    tables = pt.pack_traversal(scene)
    reset_launches()
    with torch.no_grad():
        color, _, albedo = render_tiled(scene, cam, SLICE, mesh, H, W, frame=3, tables=tables)
    run = launches()
    add_launches(total, run)
    expect_launches("render_tiled", run, dict(k1=1, k2=2, k3=0, k4=0, k5=0, k6=0, k7=0))
    d = cam.ray_directions(H, W).reshape(-1, 3)
    yy, xx = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")
    with torch.no_grad():
        ref = pt.trace_paths(scene, cam.eye[None], d, xx.reshape(-1), (H - 1 - yy).reshape(-1),
                             3, SLICE, common_origin=True, tables=tables)
    full = gather_rows(mesh, color, H)
    if not (torch.equal(full, ref.color.reshape(H, W, 3))
            and torch.equal(albedo, ref.albedo.reshape(H, W, 3))):
        raise AssertionError("render_tiled differs from trace_paths")
    log(f"render_tiled at {W}x{H}: bit-equal to trace_paths on the same rays, launches {run}")
    # K1 on the sharded path's row-major primaries and on the frame's 32x32 tiles
    orig, d_tiles, _, _ = camera_rays(cam, H, W)
    k1_rows = kernel_ms(lambda: kt.trace_packets(tables, cam.eye[None], d, INF, common_origin=True))
    k1_tiles = kernel_ms(lambda: kt.trace_packets(tables, orig, d_tiles, INF, common_origin=True))
    log(f"K1 on the {d.shape[0]} primaries: row-major (the sharded paths) {k1_rows:.4f} ms, "
        f"32x32 tiles (the frame) {k1_tiles:.4f} ms")

    # the sharded train step against make_train_step: 2 steps each
    tcfg = RenderConfig(width=W, height=H, max_tracing_depth=2, compact_frac=0.0,
                        compact_auto=False)
    res = {}
    for sharded in (False, True):
        params, rebuild = optimize.split_trainable(scene, device=dev)
        with torch.no_grad():
            target = optimize.render_flat(rebuild(params), cam, tcfg, H, W, 0)
            params["materials"].base_color.mul_(0.4).add_(0.3)
        opt = (lambda p: lambda _: torch.optim.Adam([p["materials"].base_color], lr=1e-2))(params)
        init, step = (optimize.make_sharded_train_step(rebuild, tcfg, H, W, mesh, opt)
                      if sharded else optimize.make_train_step(rebuild, tcfg, H, W, opt))
        state = init(params)
        losses, step_ms = [], []
        reset_launches()
        for _ in range(DIST_TRAIN_STEPS):
            t0 = time.perf_counter()
            state, loss = step(state, target, cam, 0)
            losses.append(float(loss))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        run = launches()
        if sharded:
            add_launches(total, run)
            expect_launches("sharded train steps", run, dict(
                k1=DIST_TRAIN_STEPS, k2=2 * DIST_TRAIN_STEPS, k3=0, k4=0, k5=0, k6=0, k7=0))
        table = state.params["materials"]
        res[sharded] = (losses, step_ms,
                        {f.name: getattr(table, f.name).detach() for f in dataclasses.fields(table)},
                        {f.name: getattr(table, f.name).grad for f in dataclasses.fields(table)})
    (l0, ms0, p0, g0), (l1, ms1, p1, g1) = res[False], res[True]
    worst = max(float((p1[k] - p0[k]).abs().max()) for k in p0)
    g_err = max(float((g1[k] - g0[k]).abs().max()) / max(float(g0[k].abs().max()), 1e-30)
                for k in g0)
    log(f"sharded train steps: {DIST_TRAIN_STEPS} at {W}x{H}, depth 2, Adam lr 1e-2 on "
        f"base_color: losses {l1} vs make_train_step {l0}; step ms {[round(x, 3) for x in ms1]} "
        f"vs {[round(x, 3) for x in ms0]}; last step's gradients max |diff| / max |g| per field "
        f"{g_err:.3g}; parameters max |diff| {worst:.3g} (atol {DIST_PARAM_ATOL})")
    if (any(abs(a - b) > 1e-5 * abs(b) for a, b in zip(l1, l0)) or worst > DIST_PARAM_ATOL
            or g_err > GRAD_ATOL):
        raise AssertionError("the sharded train step differs from make_train_step")

    phase_elastic(scene, dev)
    phase_cli_elastic()

    # wall, device ms and busy share: the sharded frame beside render_frame's
    runs = [FrameRun(scene, SLICE, "render_frame (K4, K5)"),
            FrameRun(scene, SLICE_PLAIN, "render_frame (plain denoiser)"),
            ShardedRun(scene, SLICE, "render_frame_sharded (K4, K5; world of one)", mesh),
            ShardedRun(scene, SLICE_PLAIN, "render_frame_sharded (plain stages)", mesh)]
    walls = [r.time_frames(DIST_TIMED_FRAMES) for r in runs]
    prof = [r.profile_frames(DIST_PROFILE_FRAMES, wall, Path("build/profile"))
            for r, wall in zip(runs, walls)]
    for r, p in zip(runs, prof):
        got = (p["events"]["K4"], p["events"]["K5"])
        log(f"{r.tag}: the profile holds K4 {got[0]} and K5 {got[1]} of launches "
            f"{p['launches']}, K4 {p['ours_ms']['K4']:.4f} and K5 {p['ours_ms']['K5']:.4f} "
            f"device ms a frame; padding kernels the profiler lost {p['dropped']}, sessions "
            f"{p['sessions']}")
        if got != (p["launches"]["k4"], p["launches"]["k5"]):
            raise AssertionError(f"{r.tag}: the profile misses K4 or K5")
    log("frames at 800x800, the default view (compact_frac 0): " + "; ".join(
        f"{r.tag}: wall median {p['wall_ms']:.3f} ms (min {min(w):.3f}, max {max(w):.3f}), "
        f"device {p['device_ms_per_frame']:.3f} ms, {p['kernels_per_frame']:.1f} kernels, "
        f"busy share {p['busy_share']:.3f}" for r, w, p in zip(runs, walls, prof)))
    return total, k1_rows, k1_tiles


def phase_elastic(scene, dev) -> None:
    """18, elastic: run_elastic over DIST_ELASTIC_FRAMES card frames with one
    injected CUDA fault against an uninterrupted run."""
    cam = OrbitCamera(width=W, height=H)
    tables, pk = pt.pack_traversal(scene), pack_scene_tables(scene)

    @torch.no_grad()
    def frame_fn(state, frame):
        cam.yaw_deg = 0.5 * frame
        return render_frame(scene, cam.snapshot(dev), state, SLICE, H, W, tables=tables,
                            pk=pk)[0]

    armed = {DIST_ELASTIC_FRAMES // 2 + 1}

    def flaky(state, frame):
        if frame in armed:
            armed.discard(frame)
            raise RuntimeError("CUDA error: an illegal memory access was encountered "
                               "(injected)")
        return frame_fn(state, frame)

    ck = Path(__file__).resolve().parent / "build"
    s0 = FrameState.initial(H, W, dev)
    t0 = time.perf_counter()
    ref, _ = run_elastic(frame_fn, s0, DIST_ELASTIC_FRAMES, str(ck / "elastic_ref.npz"),
                         checkpoint_every=2)
    t1 = time.perf_counter()
    got, stats = run_elastic(flaky, s0, DIST_ELASTIC_FRAMES, str(ck / "elastic.npz"),
                             checkpoint_every=2)
    t2 = time.perf_counter()
    same = all(torch.equal(getattr(got, f), getattr(ref, f))
               for f in ("illum_hist", "variance_hist", "prev_normal", "prev_linear_z",
                         "moments", "history_len", "accum_color", "taa_color"))
    log(f"elastic: {DIST_ELASTIC_FRAMES} frames at {W}x{H}, a fault injected before frame "
        f"{DIST_ELASTIC_FRAMES // 2 + 1}: {stats.faults} faults, {stats.restores} restores, "
        f"{stats.replayed_frames} replayed, {stats.checkpoints} checkpoints; "
        f"{(t2 - t1) * 1e3:.0f} ms against {(t1 - t0) * 1e3:.0f} ms uninterrupted; final "
        f"state bit-equal: {same}")
    if not same or stats.restores != 1 or got.frame_idx != DIST_ELASTIC_FRAMES:
        raise AssertionError("the elastic run did not resume bit for bit")


def phase_cli_elastic() -> None:
    """18, the CLI's supervised render on the card, as a user runs it."""
    root = Path(__file__).resolve().parent
    png, ck = root / "build" / "cli_elastic.png", root / "build" / "cli_elastic.npz"
    png.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "tpuray_torch.cli.main", "render", "--elastic", str(ck),
           "--checkpoint-every", "2", "--frames", "4", "--size", "800", "--out", str(png)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
    log(f"cli: {' '.join(cmd[1:])} -> exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; stderr: {proc.stderr.strip()[-600:]}")
    if proc.returncode != 0 or "elastic: 4 frames" not in proc.stderr:
        raise AssertionError(f"the CLI's elastic render exited {proc.returncode}")
    img = read_png(str(png))
    if img.shape != (H, W, 3) or not bool((img > 0).any()):
        raise AssertionError(f"the CLI wrote an image of shape {img.shape}")


class FrameLog:
    """Records each frame a Renderer renders on any thread: the config and
    static-camera choice render_frame got, the frame index it started from,
    a host copy of the camera's view matrix, the launches it made, whether
    the residual pass ran (the hit count read against the budget) and a
    copy of its final image. Installed by wrapping renderer.render_frame
    and path_tracer.host_count."""

    def __init__(self):
        self.frames: list[dict] = []
        self._counts: list[int] = []
        self._saved = None

    def __enter__(self):
        from tpuray_torch.render import renderer as rmod
        real_frame, real_count = rmod.render_frame, pt.host_count

        def count(c):
            n = real_count(c)
            self._counts.append(n)
            return n

        def frame(scene, camera, state, cfg, height, width, **kw):
            before, self._counts[:] = launches(), []
            new_state, out = real_frame(scene, camera, state, cfg, height, width, **kw)
            after = launches()
            budget = pt._compact_budget(height * width, cfg)
            self.frames.append(dict(
                cfg=cfg, static=kw.get("static_camera", False), frame_idx=state.frame_idx,
                view=camera.view_proj.cpu(),
                launches={k: after[k] - before[k] for k in after},
                residual=bool(budget and any(n > budget for n in self._counts)),
                final=out.final.clone()))
            return new_state, out

        self._saved = (rmod, real_frame, real_count)
        rmod.render_frame, pt.host_count = frame, count
        return self

    def __exit__(self, *exc):
        rmod, real_frame, real_count = self._saved
        rmod.render_frame, pt.host_count = real_frame, real_count

    def expected(self, f: dict) -> dict:
        """A single-tree frame's launches on the card: K1 1, K2 a bounce
        (again with the residual pass), K4 1 (a still camera too), K5 an
        iteration, TAA 1."""
        d = f["cfg"].max_tracing_depth
        return dict(k1=1, k2=d * (2 if f["residual"] else 1), k3=0, k4=1,
                    k5=f["cfg"].num_atrous_iterations, k6=0, k7=0, taa=1)


def http(port: int, path: str, body: dict | None = None, timeout: float = 60.0):
    """(status, headers, bytes) of a GET, or of a POST of JSON `body`."""
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=None if body is None else json.dumps(body).encode(),
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def poll_frames(port: int, n: int, seq: int = -1) -> list[tuple]:
    """Long-poll n frames, each newer than the last -> [(seq, stats, png)]."""
    got = []
    while len(got) < n:
        status, headers, png = http(port, f"/frame.png?seq={seq}")
        if status == 204:
            continue
        seq = int(headers["X-Seq"])
        got.append((seq, json.loads(headers["X-Stats"]), png))
    return got


def event(port: int, flog: FrameLog, ev: dict) -> int:
    """POST a control event, then wait until a frame that started after it
    is published (the third frame polled from then: the first may be older
    than the POST, the second may have started before it) -> how many
    frames were logged when the POST returned: the event reaches frame
    n or n + 1."""
    http(port, "/control", ev)
    n = len(flog.frames)
    poll_frames(port, 3)
    return n


def check_png(name: str, png: bytes, size: int) -> None:
    """The PNG decodes to a finite size x size RGB image."""
    path = Path("build") / "viewer_frame.png"
    path.write_bytes(png)
    img = read_png(str(path))
    if img.shape != (size, size, 3) or not bool(torch.isfinite(torch.from_numpy(img)).all()):
        raise AssertionError(f"{name}: PNG of shape {img.shape}")


def viewer_times(scene, size: int) -> tuple[float, float, dict]:
    """The viewer's own ms per frame (median of its X-Stats), the fps a
    client long-polling it sees, and the median ms of a frame's parts
    (Renderer.step's host call; tonemap and the copy to the host, which
    waits for the device; the PNG; and, for comparison, a Renderer's step
    and copy on this thread with no server running), under RenderConfig()
    at size x size with no frame cap."""
    from tpuray_torch.viewer import server as vs
    s = vs.ViewerServer(scene, RenderConfig(width=size, height=size), port=0, max_fps=1e6)
    parts = {"step": [], "tonemap + copy": [], "png": []}
    marks = {}
    real_step, real_png = s.renderer.step, vs.encode_png

    def step(camera):
        t0 = time.perf_counter()
        out = real_step(camera)
        marks["step"] = t0, time.perf_counter()
        return out

    def png(img, **kw):
        t0 = time.perf_counter()
        data = real_png(img, **kw)
        parts["step"].append((marks["step"][1] - marks["step"][0]) * 1e3)
        parts["tonemap + copy"].append((t0 - marks["step"][1]) * 1e3)
        parts["png"].append((time.perf_counter() - t0) * 1e3)
        return data

    s.renderer.step, vs.encode_png = step, png
    s.start()
    try:
        poll_frames(s.port, 3)  # warm-up
        t0 = time.perf_counter()
        got = poll_frames(s.port, VIEW_TIMED_FRAMES)
        wall = time.perf_counter() - t0
    finally:
        s.stop()
        vs.encode_png = real_png
    s.check()
    # the same frames from a Renderer on this thread, no server around it
    r = Renderer(scene, RenderConfig(width=size, height=size))
    cam = OrbitCamera(width=size, height=size).snapshot()
    parts["direct step + copy"] = []
    for _ in range(VIEW_TIMED_FRAMES):
        t0 = time.perf_counter()
        tonemap(r.step(cam).final).cpu()
        parts["direct step + copy"].append((time.perf_counter() - t0) * 1e3)
    seqs = [g[0] for g in got]
    return (statistics.median(g[1]["ms"] for g in got), (seqs[-1] - seqs[0]) / wall,
            {k: round(statistics.median(v[3:]), 3) for k, v in parts.items()})


def phase_viewer(dev) -> dict:
    """19. The viewer on the card -> its counted frames' launches."""
    from tpuray_torch.viewer.server import ViewerServer
    scene = file_scene(4, device=dev)
    cfg = RenderConfig(width=VIEW_SIZE, height=VIEW_SIZE)
    total = dict(k1=0, k2=0, k3=0, k4=0, k5=0, k6=0, k7=0)
    with FrameLog() as flog:
        s = ViewerServer(scene, cfg, port=0)
        s.start()
        try:
            got = poll_frames(s.port, VIEW_FRAMES)
            n_quiet = len(flog.frames)
            n_post = event(s.port, flog, {"type": "param", "name": "num_atrous_iterations",
                                          "value": 3})
            n_sigma = event(s.port, flog, {"type": "param", "name": "sigma_l", "value": 2.5})
            n_rot = event(s.port, flog, {"type": "rotate", "dx": 5.0, "dy": 0.0})
            n_view = event(s.port, flog, {"type": "view", "view": 2})
            seq, stats, png = poll_frames(s.port, 1)[-1]
            check_png("viewer variance view", png, VIEW_SIZE)
            state = json.loads(http(s.port, "/state")[2])
            # checked after the events, so that the first follows the 30th
            # frame closely and the plain replay below stays short
            for q_seq, _, q_png in got:
                check_png(f"viewer frame {q_seq}", q_png, VIEW_SIZE)
        finally:
            s.stop()
        s.check()
    frames = flog.frames
    if any(f["static"] for f in frames):
        raise AssertionError("a viewer frame on the card took the plain static-camera branch")
    for i, f in enumerate(frames):
        expect_launches(f"viewer frame {i}", f["launches"], flog.expected(f))
        add_launches(total, f["launches"])
    after = frames[n_post + 1:]  # a frame may have been in flight during the POST
    first3 = next(i for i, f in enumerate(frames) if f["cfg"].num_atrous_iterations == 3)
    if not (n_post <= first3 <= n_post + 1 and frames[first3]["frame_idx"] == 0
            and all(f["cfg"].num_atrous_iterations == 3 for f in after)):
        raise AssertionError(f"num_atrous_iterations=3 reached frame {first3} (posted "
                             f"after frame {n_post})")
    if not all(f["cfg"].sigma_l == 2.5 for f in frames[n_sigma + 1:]):
        raise AssertionError("sigma_l=2.5 did not reach the frames after it")
    moved = [i for i in (n_rot, n_rot + 1)
             if not torch.equal(frames[i]["view"], frames[i - 1]["view"])]
    if len(moved) != 1 or frames[moved[0]]["frame_idx"] != 0:
        raise AssertionError("the rotate event did not reach one moving frame: "
                             + str([(i, frames[i]["frame_idx"]) for i in moved]))
    if not (stats["text"].split("\n")[1].startswith("view: svgf_variance")
            and state["view"] == 2 and state["params"]["num_atrous_iterations"] == 3):
        raise AssertionError(f"view switch: stats {stats}, state {state}")
    residual = sum(f["residual"] for f in frames)
    log(f"viewer: {len(frames)} frames at {VIEW_SIZE}x{VIEW_SIZE} on the 5k file scene, "
        f"{VIEW_FRAMES} long-polled with no event (PNGs {VIEW_SIZE}x{VIEW_SIZE}, finite); "
        f"launches per frame as expected (K4 on every frame, residual passes "
        f"{residual}); total {total}; "
        f"num_atrous_iterations=3 from frame {first3} (posted after {n_post}), frame_idx "
        f"back at 0; sigma_l and the view switch applied (posted after {n_sigma}, {n_view})")

    # no events: the server's n-th final equals a direct Renderer's n-th
    r = Renderer(scene, cfg)
    cam = OrbitCamera(width=VIEW_SIZE, height=VIEW_SIZE).snapshot()
    for i in range(n_quiet):
        out = r.step(cam)
    if not torch.equal(out.final, frames[n_quiet - 1]["final"]):
        d = float((out.final - frames[n_quiet - 1]["final"]).abs().max())
        raise AssertionError(f"viewer frame {n_quiet}: final differs from a Renderer's by {d}")
    log(f"viewer: frame {n_quiet}'s final bit-equal to a direct Renderer's after "
        f"{n_quiet} steps of the same camera")

    # the same frames through the plain versions: the last quiet frame, then
    # the last frame with 3 iterations before sigma_l (the event replayed as
    # _apply_events applies it: the config, then a reset keeping the history)
    last3 = max(i for i, f in enumerate(frames) if f["cfg"].num_atrous_iterations == 3
                and f["cfg"].sigma_l == cfg.sigma_l)
    p = Renderer(scene, dataclasses.replace(cfg, pallas_denoise=False), tracer=pt.PLAIN)
    t0 = time.perf_counter()
    for i in range(last3 + 1):
        if i == first3:
            p.cfg = p.cfg.replace(num_atrous_iterations=3)
            p.reset()
        out = p.step(cam)
        if i in (n_quiet - 1, last3):
            assert_images_close(f"viewer frame {i + 1} final ({frames[i]['cfg'].num_atrous_iterations}"
                                f" iterations), kernels vs plain", frames[i]["final"], out.final)
    log(f"viewer: {last3 + 1} plain-version frames in {time.perf_counter() - t0:.1f} s")

    for size in (VIEW_SIZE, 800):
        ms, fps, parts = viewer_times(scene, size)
        log(f"viewer {size}x{size}, RenderConfig(), no frame cap: its own ms/frame median "
            f"{ms:.3f} (events, step, tonemap, the copy to the host, PNG), client fps "
            f"{fps:.2f} over {VIEW_TIMED_FRAMES} long-polled frames; medians of its parts "
            f"{parts} ms")
    phase_cli_view()
    return total


def phase_cli_view() -> None:
    """19. `view` through the CLI: the URL line, /, /state, 3 frames, then
    SIGINT must end it with exit 0 within 30 s."""
    import signal
    import threading
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "tpuray_torch.cli.main", "view", "--port", "0"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        lines: list[str] = []
        reader = threading.Thread(target=lambda: lines.append(proc.stdout.readline()),
                                  daemon=True)
        reader.start()
        reader.join(timeout=300)
        m = re.search(r"http://[^:]+:(\d+)/", lines[0] if lines else "")
        if not m:
            raise AssertionError(f"view printed {lines}; stderr {proc.stderr.read()[-2000:]}"
                                 if proc.poll() is not None else f"view printed {lines}")
        port = int(m.group(1))
        page = http(port, "/")[2]
        state = json.loads(http(port, "/state")[2])
        got = poll_frames(port, 3)
        for seq, stats, png in got:
            check_png(f"view frame {seq}", png, VIEW_SIZE)
        up = time.perf_counter() - t0
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = proc.stderr.read()
    log(f"cli view: {lines[0].strip()} after {up:.1f} s; page {len(page)} bytes, state "
        f"{state}, 3 frames ({[g[1]['ms'] for g in got]} ms); SIGINT -> exit {rc}")
    if rc != 0 or b"tpuray" not in page or state["width"] != VIEW_SIZE:
        raise AssertionError(f"view exited {rc}; stderr {err[-2000:]}")


def _cli_train(args: list[str], prefix: str, falls: bool) -> tuple[list[float], float]:
    """`train` as a subprocess -> (printed losses, final loss): exit 0, both
    PNGs at the size asked for, finite losses, and with `falls` the final
    loss below the first."""
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "tpuray_torch.cli.main", "train", *args,
           "--out-prefix", prefix]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
    losses = [float(x) for x in re.findall(r"step \d+: loss ([0-9.eE+-]+)", proc.stderr)]
    final = re.search(r"final loss ([0-9.eE+-]+)", proc.stderr)
    log(f"cli: {' '.join(cmd[3:])} -> exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; losses {losses}, "
        f"{final.group(0) if final else 'no final loss'}")
    if proc.returncode != 0 or not losses or final is None:
        raise AssertionError(f"train exited {proc.returncode}: {proc.stderr[-2000:]}")
    size = int(args[args.index("--size") + 1]) if "--size" in args else 64
    for name in ("target", "fit"):
        img = read_png(f"{prefix}_{name}.png")
        if img.shape != (size, size, 3):
            raise AssertionError(f"train wrote a {name} PNG of shape {img.shape}")
    if not all(math.isfinite(x) for x in losses + [float(final.group(1))]):
        raise AssertionError(f"train losses are not finite: {losses}, {final.group(0)}")
    if falls and not float(final.group(1)) < losses[0]:
        raise AssertionError(f"the train loss does not fall: {losses}, {final.group(0)}")
    return losses, float(final.group(1))


def phase_cli_train() -> dict:
    """20. `train` through the CLI at its defaults and at 256x256, depth 2,
    then the 256x256 run in this process with each step timed and its
    launches counted -> those steps' launches."""
    from tpuray_torch.cli import main as cli
    _cli_train([], "build/train_default", falls=True)
    # at lr 0.05 Adam on every leaf overshoots at depth 2 in tpuray too: its
    # loss after the first step is ~4x the first (tests/test_torch_cli.py
    # test_train_at_256_follows_tpuray)
    _cli_train(TRAIN_CLI, "build/train_256", falls=False)

    steps, real = [], optimize.make_train_step
    counts: list[int] = []
    real_count = pt.host_count

    def make(rebuild, cfg, height, width, *a, **kw):
        init, step = real(rebuild, cfg, height, width, *a, **kw)
        budget = pt._compact_budget(height * width, cfg)

        def timed(*sa, **skw):
            torch.cuda.synchronize()
            before, counts[:] = launches(), []
            t0 = time.perf_counter()
            state, loss = step(*sa, **skw)
            torch.cuda.synchronize()
            after = launches()
            steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                              launches={k: after[k] - before[k] for k in after},
                              residual=bool(budget and any(n > budget for n in counts)),
                              depth=cfg.max_tracing_depth))
            return state, loss
        return init, timed

    def count(c):
        n = real_count(c)
        counts.append(n)
        return n

    optimize.make_train_step, pt.host_count = make, count
    try:
        rc = cli.main(["train", *TRAIN_CLI, "--out-prefix", "build/train_timed"])
    finally:
        optimize.make_train_step, pt.host_count = real, real_count
    if rc != 0:
        raise AssertionError(f"train returned {rc}")
    total = dict(k1=0, k2=0, k3=0, k4=0, k5=0, k6=0, k7=0)
    for i, s in enumerate(steps):
        expect_launches(f"train step {i}", s["launches"], dict(
            k1=1, k2=s["depth"] * (2 if s["residual"] else 1), k3=0, k4=0, k5=0, k6=0, k7=0))
        add_launches(total, s["launches"])
    ms = [round(s["ms"], 3) for s in steps]
    log(f"train through the CLI, {' '.join(TRAIN_CLI)}: step ms {ms}, median "
        f"{statistics.median(ms):.3f} ms (steps 2-{len(ms)}: "
        f"{statistics.median(ms[1:]):.3f}); launches a step "
        f"{steps[-1]['launches']} (residual pass {steps[-1]['residual']}); total {total}")
    size, depth = (int(TRAIN_CLI[TRAIN_CLI.index(k) + 1]) for k in ("--size", "--depth"))
    train_check(cli._build_scene("procedural", False).to("cuda"),
                RenderConfig(width=size, height=size, max_tracing_depth=depth), "cuda",
                "train CLI step")
    return total


def _same_tree(name: str, got: dict, want: dict) -> int:
    """The native BVH against the numpy one: first_tri, tri_count and skip
    equal, the boxes within atol 1e-6, every leaf holding the same
    triangles -> how many perm positions differ (tied centroids that the
    two sorts order differently inside a leaf)."""
    import numpy as np
    for k in ("first_tri", "tri_count", "skip"):
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{name}: {k} differs from the numpy build")
    box = max(float(np.abs(got[k] - want[k]).max()) for k in ("aabb_min", "aabb_max"))
    if box > 1e-6:
        raise AssertionError(f"{name}: boxes differ by {box}")
    for f, c in zip(want["first_tri"], want["tri_count"]):
        if c and set(got["perm"][f:f + c].tolist()) != set(want["perm"][f:f + c].tolist()):
            raise AssertionError(f"{name}: leaf at {f} holds other triangles")
    return int((got["perm"] != want["perm"]).sum())


# bench.py's metrics, in its order, with the launches each run must make
# (timed_stats: one warm-up call, then trials x iters); None: checked in
# phase_bench
BENCH_METRICS = {
    "trace_rays_per_second": dict(k1=1 + 20 * 6),
    "trace_incoherent_rays_per_second": dict(k3=1 + 8 * 3),
    "frame_ms_moving_800px": None,
    "svgf_chain_ms_moving_1080p": dict(k4=1 + 5 * 3, k5=5 * (1 + 5 * 3), taa=1 + 5 * 3),
    **{f"gradcheck_{name}_rel_err": None for name in
       ("base_color", "specular", "sheen", "light_radiance", "light_pos_interior")},
    "gradcheck_roughness_d2_ad_sanity": None,
    "trace_chunked_131k_rays_per_second": dict(k6=1 + 8 * 3),
    "trace_chunked_524k_rays_per_second": dict(k6=1 + 8 * 3),
    "bench_total_s": {},
}


def held_events(stages, spin: int = 1 << 26) -> tuple[list, float, bool]:
    """Each stage() on the device, timed by events in one queue behind a
    spin kernel -> (device ms of each stage, the host's ms to queue them
    all, whether the spin ended before the host had queued them: then the
    readings are host-paced)."""
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
    torch.cuda.synchronize()
    torch.cuda._sleep(spin)
    t0 = time.perf_counter()
    evs[0].record()
    for stage, ev in zip(stages, evs[1:]):
        stage()
        ev.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    drained = evs[0].query()
    torch.cuda.synchronize()
    return [x.elapsed_time(y) for x, y in zip(evs, evs[1:])], host_ms, drained


def chain_profile(fn) -> None:
    """One call of fn under torch.profiler (profile_frames.profiled) behind
    a spin kernel, events around it: the device kernels' own time, their
    span, the gaps between them, memcpy/memset, the host's synchronising
    calls, and the events' span beside the kernels' (a kernel the profiler
    did not record shows as the difference). Fails unless the profile holds
    every K4 and K5 launch."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def call():
        reset_launches()
        torch.cuda._sleep(1 << 26)
        start.record()
        fn()
        end.record()

    prof, _, lost, sessions = profiled(call)
    run = launches()
    events = prof.events()
    work = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and "spin_kernel" not in e.name),
                  key=lambda e: e.time_range.start)
    syncs = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and (
                "Synchronize" in e.name or e.name == "aten::_local_scalar_dense"):
            syncs[e.name] = syncs.get(e.name, 0) + 1
    by_name, gaps, end_us = {}, [], None
    for e in work:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        if end_us is not None:
            gaps.append(max(0.0, e.time_range.start - end_us))
        end_us = max(end_us or 0.0, e.time_range.end)
    span = end_us - work[0].time_range.start
    own = sum(us for _, us in by_name.values())
    mem = {k: v for k, v in by_name.items() if k.startswith(("Memcpy", "Memset"))}
    ours = {k: sum(n for name, (n, _) in by_name.items() if k in name)
            for k in ("reproject_variance", "atrous_step")}
    gaps.sort()
    log(f"bench 1080p chain, one call under torch.profiler behind a spin kernel: "
        f"{len(work)} device events (K4 {ours['reproject_variance']}, K5 "
        f"{ours['atrous_step']}; {sum(n for n, _ in mem.values())} memcpy/memset), "
        f"their own time {own / 1e3:.4f} ms, span {span / 1e3:.4f} ms; the events' span "
        f"{start.elapsed_time(end):.4f} ms; {len(gaps)} gaps, {sum(gaps) / 1e3:.4f} ms "
        f"in all, median {gaps[len(gaps) // 2]:.2f} us, largest {gaps[-1]:.2f} us; host "
        f"syncs {syncs} (one ends the profile); padding kernels the profiler lost "
        f"{lost} of {SESSION_PAD}, sessions {sessions}")
    if (ours["reproject_variance"], ours["atrous_step"]) != (run["k4"], run["k5"]):
        raise AssertionError(f"the chain's profile holds K4 {ours['reproject_variance']} and "
                             f"K5 {ours['atrous_step']} of launches {run}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    log("bench 1080p chain, its largest device events: "
        + "; ".join(f"{name[:90]} x{n} {us / 1e3:.4f} ms" for name, (n, us) in top))


def bench_chain_against_plain(chain_ms: float) -> float:
    """22, after the bench: the 1080p chain's inputs rebuilt from
    bench.svgf_inputs; K4 and each K5 iteration against their plain
    versions on them, the whole chain against the plain denoiser, its
    device time a call (kernel_ms) beside the bench's host time a call,
    each stage's device time (held_events), and one call under
    torch.profiler (chain_profile) -> the device ms a call."""
    dev = torch.device("cuda")
    gbuf, st, color, emi, alb = bench.svgf_inputs(1080, 1920, dev)
    cfg = RenderConfig(width=1920, height=1080)
    k4_in = reproject_inputs(color, emi, alb, gbuf, st)
    k4, *_ = check_k4("bench K4 1080p", cfg, k4_in)
    check_k5_iterations("bench K5 1080p", (k4.var_illum, k4.var_variance, k4_in["normal"],
                                           k4_in["linear_z"], k4_in["fwidth_z"]), cfg)
    assert_images_close("bench 1080p chain, kernels vs the plain denoiser",
                        svgf_pipeline(color, emi, alb, gbuf, st, cfg).taa,
                        svgf_pipeline(color, emi, alb, gbuf, st,
                                      dataclasses.replace(cfg, pallas_denoise=False)).taa)
    del k4, k4_in

    def chain():
        return svgf_pipeline(color, emi, alb, gbuf, st, cfg).taa

    # one call a reading: five calls' ~2,800 launches overflow the launch
    # queue, and the host then waits for the spin (kernel_ms)
    chain_dev = kernel_ms(chain, 1)
    log(f"bench svgf_chain_ms_moving_1080p: {chain_ms} ms a call (host clock, min of "
        f"trials); device {chain_dev:.4f} ms a call (kernel_ms, one call a reading): "
        f"{'host' if chain_ms > 1.1 * chain_dev else 'device'}-bound, the device's span "
        f"{chain_dev / chain_ms:.2f} of the call")
    # svgf_pipeline's stages one by one, as it runs them
    k4_in = reproject_inputs(color, emi, alb, gbuf, st)
    out = {}
    stages = [
        lambda: out.update(k4=kr.reproject_variance_fused(cfg, **k4_in)),
        lambda: out.update(k5=ka.chain(
            ka.atrous_step, out["k4"].var_illum, out["k4"].var_variance, k4_in["normal"],
            k4_in["linear_z"], k4_in["fwidth_z"], cfg)[0][0]),
        lambda: out.update(mod=modulate(out["k5"], alb, emi, gbuf.linear_z)),
        lambda: ktaa.taa(out["mod"], st.taa_color, gbuf.velocity, gbuf.linear_z,
                         st.frame_idx)]
    held_events(stages)  # warm-up
    parts, host_ms, drained = held_events(stages)
    log(f"bench 1080p chain by stage, device ms behind a spin kernel (the host queued "
        f"them in {host_ms:.4f} ms, {'after' if drained else 'before'} the spin ended): "
        + ", ".join(f"{k} {v:.4f}" for k, v in zip(("K4", "K5 x5", "modulate", "TAA"), parts))
        + f"; sum {sum(parts):.4f}")
    check_taa("bench 1080p", (out["mod"], st.taa_color, gbuf.velocity, gbuf.linear_z,
                              st.frame_idx))
    del k4_in, out
    chain_profile(chain)
    return chain_dev


def bench_inputs_against_plain(metrics: dict, k1_ms: float, k3_ms: float,
                               forests: dict) -> None:
    """22, after the bench: its inputs rebuilt here from its own functions
    (the flagship scene, primary_rays, incoherent_inputs, svgf_inputs) and
    phase 8's and 9's forests (forests: label -> (tables, triangles)), each
    kernel against its plain version, and its device time (kernel_ms)
    beside the bench's rate a call (host clock: the wrapper's call, launch
    included)."""
    import numpy as np
    dev = torch.device("cuda")
    scene, _ = bench.flagship_scene(dev)
    tables = pt.pack_traversal(scene)
    o_np, d_np = bench.primary_rays(OrbitCamera(width=W, height=H).snapshot(), H, W)
    o = torch.from_numpy(np.ascontiguousarray(o_np)).to(dev)
    d = torch.from_numpy(d_np).to(dev)
    tm = torch.full((d.shape[0],), INF, device=dev)
    _, k1_dev, *_ = check_class("bench K1 primaries", kt.trace_packets,
                                kt.trace_packets_plain, tables, (o, d, INF, False, True),
                                any_hit=False)
    p_inc, d_inc = bench.incoherent_inputs(o, d, kt.trace_packets(
        tables, o, d, INF, common_origin=True)[0])
    _, k3_dev, *_ = check_class("bench K3 incoherent", kt.trace_batched,
                                kt.trace_packets_plain, tables, (p_inc, d_inc, tm, False),
                                any_hit=False)
    bench_chain_against_plain(metrics["svgf_chain_ms_moving_1080p"]["value"])
    device = {"trace_rays_per_second": ("K1", k1_dev, f"phase 1's {k1_ms:.4f}"),
              "trace_incoherent_rays_per_second": ("K3", k3_dev,
                                                   f"phase 11's bounce ray {k3_ms:.4f}")}
    # the forests of phases 8 and 9: make_large_scene's geometry at the
    # bench's sizes (the bench's smaller environment map does not reach the
    # traversal)
    for label, (forest, n_tris) in forests.items():
        m = f"trace_chunked_{label}_rays_per_second"
        if (metrics[m]["tris"], metrics[m]["chunks"]) != (n_tris, forest.n_chunks):
            raise AssertionError(f"bench {m}: {metrics[m]} is not the forest of "
                                 f"{n_tris} triangles in {forest.n_chunks} chunks")
        _, ms, *_ = check_class(f"bench K6 {label} primaries", ktc.trace_chunked,
                                ktc.trace_chunked_plain, forest, (o, d, tm, False, True),
                                any_hit=False)
        device[m] = ("K6", ms, "")
    n_rays = d.shape[0]
    for m, (kernel, device_ms, other) in device.items():
        call_ms = n_rays / metrics[m]["value"] * 1e3
        log(f"bench {m}: {metrics[m]['value'] / 1e9:.3f} G rays/s, {call_ms:.4f} ms a call "
            f"(host clock, min of trials; median {metrics[m]['spread_mrays']['median']} M "
            f"rays/s); {kernel} device {device_ms:.4f} ms on these rays "
            f"({n_rays / device_ms / 1e6:.2f} G rays/s; {other}): "
            f"{'host' if call_ms > 1.1 * device_ms else 'device'}-bound, device busy "
            f"{device_ms / call_ms:.2f} of the call")


def phase_bench(k1_ms: float, k3_ms: float, forests: dict) -> dict:
    """22. `python -m tpuray_torch.cli.main bench` as a user runs it, with
    BENCH_FULL=1 -> the launches its metric lines report."""
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "tpuray_torch.cli.main", "bench"]
    t0 = time.perf_counter()
    # stderr read as the bench writes it: each metric's seconds are the gap
    # since the line before it (the headline's: from the start)
    with subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, env=dict(os.environ, BENCH_FULL="1")) as proc:
        try:
            timed_err = [(time.perf_counter(), text.rstrip("\n")) for text in proc.stderr]
            out = proc.stdout.read().splitlines()
            rc = proc.wait(timeout=600)
        finally:
            proc.kill()
    secs = time.perf_counter() - t0
    log(f"bench: {' '.join(cmd[1:])} -> exit {rc} in {secs:.1f} s")
    if rc != 0:
        raise AssertionError(f"bench exited {rc}: {[t for _, t in timed_err][-30:]}")
    if len(out) != 1:
        raise AssertionError(f"bench printed {len(out)} stdout lines: {out[:5]}")
    log(f"  bench (stdout): {out[0]}")
    head = json.loads(out[0])
    if (head.get("metric") != "trace_rays_per_second" or not head.get("value", 0) > 0
            or not {"unit", "vs_baseline", "spread_mrays"} <= set(head)):
        raise AssertionError(f"bench headline {head}")
    lines, other, last = [head], [], t0
    for at, text in timed_err:
        if text.startswith("{"):
            lines.append(json.loads(text))
            log(f"  bench ({at - last:.2f} s): {text}")
            last = at
        else:
            other.append(text)
    if other:
        log(f"  bench stderr, not JSON: {other[:10]}")
    metrics = {x["metric"]: x for x in lines if "metric" in x}
    names = [x["metric"] for x in lines if "metric" in x]
    bad = [m for m in BENCH_METRICS if m not in metrics or "error" in metrics[m]]
    if bad or names[-1] != "bench_total_s" or len(names) != len(set(names)):
        raise AssertionError(f"bench metrics missing or failed {bad}; printed {names}")
    failed = [m for m in metrics if m.startswith("gradcheck") and metrics[m]["pass"] is not True]
    if failed:
        raise AssertionError(f"bench gradient checks failed: {failed}")
    total = dict.fromkeys(launches(), 0)
    grad_runs = {}
    for m, want in BENCH_METRICS.items():
        got = metrics[m].get("launches", {})
        add_launches(total, got)
        if m.startswith("gradcheck"):
            for k, n in got.items():
                grad_runs[k] = grad_runs.get(k, 0) + n
        elif m.startswith("frame"):  # K2 2 a frame, 4 with the residual pass
            frames = 1 + 8 * 3
            if (set(got) != {"k1", "k2", "k4", "k5", "taa"} or got["k1"] != frames
                    or got["k4"] != frames or got["k5"] != 5 * frames
                    or got["taa"] != frames
                    or not 2 * frames <= got["k2"] <= 4 * frames):
                raise AssertionError(f"bench {m}: launches {got}")
        elif got != want:
            raise AssertionError(f"bench {m}: launches {got}, want {want}")
    renders = 3 * 5 + 1
    if (set(grad_runs) != {"k1", "k2"} or grad_runs["k1"] != renders
            or not 2 * renders <= grad_runs["k2"] <= 4 * renders):
        raise AssertionError(f"bench gradient checks: launches {grad_runs}")
    bench_inputs_against_plain(metrics, k1_ms, k3_ms, forests)
    log(f"bench: {len(names)} metrics, launches {total}, {secs:.1f} s")
    return total


def phase_native(dev) -> None:
    """21. The native host library against its numpy copies, set-up times,
    and a frame on a native-built scene."""
    import numpy as np
    from tpuray_torch.io import fallback, native
    from tpuray_torch.io.image import write_bmp
    from tpuray_torch.scene import host, partition
    from tpuray_torch.scene.procedural import icosphere, ground_quad, write_test_scene_obj
    if not native.available():
        raise AssertionError(f"the native library did not load: {native.build_log}")
    obj = Path("build") / "native_scene_5.obj"  # the 20k file scene's OBJ
    write_test_scene_obj(str(obj), 5)
    for got, want in zip(native.parse_obj_native(str(obj)), fallback.parse_obj_py(str(obj))):
        if not np.array_equal(got, want):
            raise AssertionError("OBJ: the native parse differs from numpy's")
    hdr = "assets/recovered_env.hdr"
    env = native.read_hdr_native(hdr)
    if not np.array_equal(env, fallback.read_hdr_py(hdr)):
        raise AssertionError("HDR: the native read differs from numpy's")
    for a, writer in (("build/native.hdr", native.write_hdr_native),
                      ("build/numpy.hdr", fallback.write_hdr_py)):
        writer(a, env[:64, :128])
    if Path("build/native.hdr").read_bytes() != Path("build/numpy.hdr").read_bytes():
        raise AssertionError("HDR: the native write differs from numpy's")
    write_bmp("build/native.bmp", np.random.default_rng(7).random((33, 47, 3)))
    if not np.array_equal(native.read_bmp_native("build/native.bmp"),
                          fallback.read_bmp_py("build/native.bmp")):
        raise AssertionError("BMP: the native read differs from numpy's")
    for name, img in (("room 512", host.procedural_room_envmap(512)), ("recovered", env)):
        got, want = native.env_cache_native(img), host.env_cache_py(img)
        pdf = float((np.abs(got[..., 2] - want[..., 2]) / want[..., 2].max()).max())
        if not np.array_equal(got[..., :2], want[..., :2]) or pdf > 1e-6:
            raise AssertionError(f"env cache {name}: differs (pdf {pdf:.3g} of its max)")
    tris20 = np.concatenate([icosphere(5), ground_quad()]).astype(np.float32) * 2.0
    ties = {"20k": _same_tree("BVH 20k", native.build_bvh_native(tris20, 8),
                              host.build_bvh_py(tris20, 8))}
    rs = np.random.RandomState(11)  # make_large_scene_arrays(25, 4)'s spheres
    blobs = []
    for _ in range(25):
        r = 0.12 + 0.18 * rs.rand()
        c = (rs.rand(3) - 0.5) * np.asarray([3.0, 1.2, 3.0])
        c[1] = max(c[1], -0.5 + r)
        blobs.append(icosphere(4, radius=r, center=tuple(c)))
    tris131 = np.concatenate(blobs + [ground_quad()]).astype(np.float32)
    for i, idx in enumerate(partition.partition_triangles(tris131, 8192)):
        ties[f"131k chunk {i}"] = _same_tree(f"BVH 131k chunk {i}",
                                             native.build_bvh_native(tris131[idx], 8),
                                             host.build_bvh_py(tris131[idx], 8))
    log(f"native: OBJ, HDR (read, write), BMP and both env caches equal their numpy "
        f"copies; BVH trees equal (boxes within 1e-6), perm positions ordered "
        f"differently by tied centroids inside a leaf {ties}")

    real = native.get_lib
    secs = {}
    for how in ("native", "numpy"):
        if how == "numpy":
            native.get_lib = lambda: None
        try:
            t0 = time.perf_counter()
            file_scene(5, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            make_large_scene(n_spheres=25, subdiv=4, env_width=512, device=dev)
            torch.cuda.synchronize()
            secs[how] = (t1 - t0, time.perf_counter() - t1)
        finally:
            native.get_lib = real
    log(f"set-up s, native vs numpy: 20k file scene {secs['native'][0]:.3f} vs "
        f"{secs['numpy'][0]:.3f}; 131k forest {secs['native'][1]:.3f} vs "
        f"{secs['numpy'][1]:.3f} (build + upload)")

    scene = file_scene(4, device=dev)  # native-built, a single tree
    tables = pt.pack_traversal(scene)
    cam = OrbitCamera(width=W, height=H, yaw_deg=20.0).snapshot(dev)
    calls = recorded_calls(scene, DEFAULT, tables, camera_rays(cam, H, W))
    for name, args, kw in calls:
        if name == "packets":
            t_k, i_k = kt.trace_packets(*args, **kw)
            check_closest("native scene K1", t_k, i_k, *kt.trace_packets_plain(*args, **kw))
        elif name == "multi":  # args: tables, origins, directions, t_max, any_hit
            got, ref = kt.trace_multi(*args, **kw), kt.trace_multi_plain(*args, **kw)
            for c, any_hit in enumerate(args[4]):
                if any_hit:
                    check_any(f"native scene K2 any-hit class {c}", got[c][1], ref[c][1])
                else:
                    check_closest(f"native scene K2 class {c}", got[c][0], got[c][1], *ref[c])
    if [c[0] for c in calls][:2] != ["packets", "multi"]:
        raise AssertionError(f"native scene frame calls {[c[0] for c in calls]}")


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
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"the native host library did not build: {native.build_log}")
    how = (f"g++ {native.build_seconds:.2f} s" if native.build_seconds
           else "already built from this source")
    log(f"native: {time.perf_counter() - t0:.2f} s ({how}) -> {native.library_path()}")
    report = build.build_log or (build.library_path().parent / "build.log").read_text()
    ptxas = ptxas_summary(report)
    for kernel, (regs, stack, spill, shared) in ptxas.items():
        log(f"  ptxas: {kernel}: {regs} registers, {stack} bytes stack frame, "
            f"{spill} bytes spill stores, {shared} bytes shared memory a block")

    fp64 = fp64_in_sass(build.library_path())
    log("  sass: FP64 instructions per kernel " + json.dumps(fp64))
    missing = [k for k in ("trace_k1_warp", "trace_k2", "trace_k3", "trace_k6",
                           "reproject_variance", "atrous_step", "gather_rows", "taa_kernel")
               if not any(name.split("<")[0] == k for name in ptxas)
               or not any(name.split("<")[0] == k for name in fp64)]
    if missing or any(fp64.values()):
        raise AssertionError(f"ptxas / sass report: kernels missing {missing}, "
                             f"FP64 instructions {fp64}")


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
    wide = kt.wide_tree(tables.meta.cpu().numpy(), tables.aabb.cpu().numpy())
    log(f"records: nodes {nbytes(tables.nodes) / 1e6:.3f} MB, K1's and K3's wide nodes "
        f"{wide.records.shape[0]} rows {nbytes(tables.wide) / 1e6:.3f} MB (a walk needs "
        f"{wide.stack} of its {kt.WIDE_STACK} stack entries), triangles "
        f"{nbytes(tables.tris) / 1e6:.3f} MB")
    table_bytes = nbytes(tables.meta, tables.aabb, tables.tverts)

    camera = OrbitCamera(width=W, height=H).snapshot(dev)
    orig, d, px, py = camera_rays(camera, H, W)

    # ---- 1. K1: camera primaries
    t_k, i_k = kt.trace_packets(tables, orig, d, INF, common_origin=True)
    (t_p, i_p), k1_plain_ms = once_ms(
        lambda: kt.trace_packets_plain(tables, orig, d, INF, common_origin=True))
    k1_err = check_closest("K1 primaries", t_k, i_k, t_p, i_p)
    k1_ms = kernel_ms(lambda: kt.trace_packets(tables, orig, d, INF, common_origin=True))
    work = {}
    kt.trace_packets_plain(tables, orig, d, INF, common_origin=True, stats=work)
    # the float t_max is a kernel argument: no (N,) array is read
    k1_bound = bound(table_bytes + nbytes(orig[:1], d, t_k, i_k),
                     work["box_tests"] * BOX_OPS + work["tri_tests"] * TRI_OPS)
    log(f"K1: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.1f} ms "
        f"({d.shape[0] / k1_ms / 1e3:.1f} Mrays/s); work {work}; "
        f"bound {k1_bound[0]:.4f} ms by {k1_bound[1]}")
    for name, o1, d1 in k1_rays(dev)[1:]:
        err, *_ = check_class(f"K1 {name}", kt.trace_packets, kt.trace_packets_plain,
                              tables, (o1, d1, INF, False, True), any_hit=False)
        k1_err = max(k1_err, err)

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
    _, _, out5, state5, k4_in = moving_renderer(scene, SLICE, 5)
    k4, k4_ref, shares, k4_err, k4_plain_ms = check_k4("K4 (frame 5)", SLICE, k4_in)
    if shares["reprojected"] <= 0.0 or shares["fallback"] <= 0.0:
        raise AssertionError("K4 inputs do not exercise both the reprojection and the fallback")
    sky, hl_p = k4_in["linear_z"] == 1.0, k4_ref.history_len
    k4_ms = kernel_ms(lambda: kr.reproject_variance_fused(SLICE, **k4_in))
    n_fail = int(((hl_p == 1) & ~sky).sum())
    n_fallback = int(((hl_p < 4) & ~sky).sum())
    k4_bound = bound(nbytes(*k4_in.values(), *k4),
                     int((~sky).sum()) * K4_PIXEL_OPS + n_fail * K4_RESCUE_OPS
                     + n_fallback * K4_FALLBACK_OPS)
    log(f"K4: kernel {k4_ms:.4f} ms (one launch; shared memory a block "
        f"{smem('reproject_variance')} bytes), plain {k4_plain_ms:.1f} ms, bound "
        f"{k4_bound[0]:.4f} ms by {k4_bound[1]}")

    # ---- 3b. K4 under the tile-windowed read and the shifted rescue
    k4_reads = phase_k4_reads(scene, k4_in, k4_ms)

    # ---- 4. K5: the 5-iteration chain on K4's output
    k5_args = (k4.var_illum, k4.var_variance, k4_in["normal"], k4_in["linear_z"],
               k4_in["fwidth_z"], SLICE)
    (fi, fv), (ti, tv) = ka.chain(ka.atrous_step, *k5_args)
    ((ri, rv), (rti, rtv)), k5_plain_ms = once_ms(lambda: ka.chain(atrous_iteration, *k5_args))
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

    # ---- 4b. K4 and K5 with a sharded frame's row window
    phase_row_window(k4_in, SLICE)

    # ---- 4c. TAA on phase 3's frame: whole image, camera still, row windows
    taa_ms, taa_plain_ms, _, taa_bound = phase_taa(out5, state5)
    del out5, state5
    log(f"TAA: shared memory a block {smem('taa_kernel')} bytes")

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
                k5=SLICE.num_atrous_iterations * TIMED_FRAMES, taa=TIMED_FRAMES)
    expect_launches("SVGF frames", main_launches, dict(want, k3=0, k6=0))
    check_image(out, svgf_on=True)
    if not hist_max[-1] > hist_max[0] > 1.0:
        raise AssertionError(f"history_len does not grow: {hist_max}")
    log(f"history_len max per frame {hist_max[0]:.0f} -> {hist_max[-1]:.0f}")

    # the camera still: on the card the moving path with zero motion (K4 and
    # K5 each frame; the static-camera branch is the CPU's)
    reset_launches()
    for _ in range(2):
        out = r.step(cam.snapshot())
    still = launches()
    log(f"still frames: 2, launches {still}")
    if still["k4"] != 2 or still["k5"] != 2 * SLICE.num_atrous_iterations:
        raise AssertionError(f"the still frames did not run K4 and K5 each: {still}")
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
    huge_tris = int(huge.triangles.count)
    del huge, calls_h

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
    forests = {"131k": (forest, int(large.triangles.count)),
               "524k": (forest_h, huge_tris)}
    del r, large, calls

    # ---- 11. K3: the five walks of a separate-walk and of a MIS frame
    k3_err, k3_frame_ms = 0.0, {}
    for name, args in k3_walks(scene, SLICE, tables, (orig, d, px, py)):
        err, ms, plain_ms, b = check_class(f"K3 {name}", kt.trace_batched,
                                           kt.trace_packets_plain, tables, args,
                                           any_hit=args[3])
        k3_err = max(k3_err, err)
        path = name.split()[0]
        k3_frame_ms[path] = k3_frame_ms.get(path, 0.0) + ms
        if name == "separate-walk bounce-0 bounce ray":
            k3_ms, k3_plain_ms, k3_bound = ms, plain_ms, b
    log("K3, the five walks of a frame: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in k3_frame_ms.items()))

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
    k7_ms, k7_plain_ms, k7_lib_ms, k7_bound = phase_k7(scene, i_k)

    # ---- 14. the gradient checks, SVGF off
    add_launches(path_launches, phase_gradchecks(scene, tables, dev))

    # ---- 15. the trainer at 800x800
    add_launches(path_launches, phase_train(scene, dev))

    # ---- 16. the default config on the test scene loaded from files, and
    # on the test scene itself: 53% of its lanes hit, so the first bucket
    # (0.5) overflows and the residual pass runs until the Renderer turns
    # compaction off
    for subdiv in (5, 4):
        add_launches(path_launches, phase_file_scene(subdiv, dev))
    run, out, buckets = default_frames(scene, False, "test scene")
    add_launches(path_launches, run)
    check_image(out, svgf_on=True)
    if buckets[0] != 0.5 or buckets[-1] != 0.0:
        raise AssertionError(f"test scene buckets {buckets}: expected 0.5, then none")

    # ---- 17. the CLI
    phase_cli()

    # ---- 18. distribution on one NCCL rank, the elastic loop
    run, k1_rows_ms, k1_tiles_ms = phase_dist(scene, dev)
    add_launches(path_launches, run)

    # ---- 19. the viewer; 20. train through the CLI; 21. the native library
    add_launches(path_launches, phase_viewer(dev))
    add_launches(path_launches, phase_cli_train())
    phase_native(dev)

    # ---- 22. the bench through the CLI
    add_launches(path_launches, phase_bench(k1_ms, k3_ms, forests))
    del forests

    def entry(name, source, replaces, key, err, ms, plain_ms, b, library_ms=None):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=path_launches[key], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                    library_ms=library_ms)

    kernels = [
        entry("K1 trace_packets", "tpuray_torch/csrc/trace_wide.cu",
              "tpuray/kernels/trace_pallas.py:233", "k1", k1_err, k1_ms, k1_plain_ms,
              k1_bound),
        entry("K2 trace_multi", "tpuray_torch/csrc/trace.cu",
              "tpuray/kernels/trace_pallas.py:416", "k2", k2_err, k2_ms, k2_plain_ms,
              k2_bound),
        entry("K3 trace_batched", "tpuray_torch/csrc/trace_wide.cu",
              "tpuray/kernels/trace_pallas.py:67", "k3", k3_err, k3_ms, k3_plain_ms,
              k3_bound),
        entry("K4 reproject_variance_fused", "tpuray_torch/csrc/reproject.cu",
              "tpuray/kernels/reproject_pallas.py:94", "k4", k4_err, k4_ms,
              k4_plain_ms, k4_bound),
        entry("K5 atrous_step", "tpuray_torch/csrc/atrous.cu",
              "tpuray/kernels/atrous_pallas.py:99", "k5", k5_err, k5_ms, k5_plain_ms,
              k5_bound),
        entry("K6 trace_chunked", "tpuray_torch/csrc/trace_chunked.cu",
              "tpuray/kernels/trace_chunked.py:66", "k6", k6_err, k6_ms, k6_plain_ms,
              k6_bound),
        entry("K7 onehot_gather", "tpuray_torch/csrc/gather.cu",
              "tpuray/kernels/gather_pallas.py:56", "k7", 0.0, k7_ms, k7_plain_ms,
              k7_bound, library_ms=k7_lib_ms),
        entry("TAA taa_kernel", "tpuray_torch/csrc/taa.cu", None, "taa", 0.0, taa_ms,
              taa_plain_ms, taa_bound),
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
