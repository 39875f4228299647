"""Device times of the traversal kernels K1, K2, K3 and K6 on the main
paths' rays, and of the K7 gather, to compare two versions of the kernels
in one call.

    python3 tpuray_torch/traversal_times.py [--tree DIR] [--parts k1,k2,k3,k6,k7]

--tree DIR imports tpuray_torch from DIR, a checkout of another commit
(for example the parent, unpacked with `git archive` into the git-ignored
build/), so the same rays go through that version's kernels; the script
calls only entry points that every version since slice 4 has. The rays:
K1's three sets of 640,000 rays from one origin (k1_rays: the 800x800
camera primaries of the test scene (20,482 triangles) in the default
view and in a view low over the ground, whose rays graze it, and random
directions from one origin), each with the float t_max the frame passes
and with a per-ray t_max tensor (older checkouts copy a float to the
card and wait for it); the default view's bounce-0 classes (K2, and K3
on each class alone); the five K3 walks of one separate-walk frame and
of one MIS frame (each recorded from trace_paths, in the frame's order);
the six K6 walks of a 131k-forest frame (primaries, bounce-0 env shadow,
point shadow and bounce ray, bounce-1 env and point shadow; the
primaries also with a per-ray t_max tensor) and the 524k forest's
primaries and bounce-0 bounce ray; K7 and its library yardstick
table[idx] on chip_smoke.py's three phase-13 cases (k7_cases). Each time
is the mean device time of 20 launches between two CUDA events, after 3
warm-ups, queued behind a spin kernel so that the host's launch overhead
does not count (kernel_ms, which chip_smoke.py and denoise_times.py use
too).
--parts picks the groups to time (default: all but k3split, which times
each K3 walk again with every lane dead and with its live rays alone,
packed into a dense array).
Prints one line per time, then one JSON line {name: ms}. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

W = H = 800


def kernel_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps calls, after 3 warm-ups. A spin
    kernel (torch.cuda._sleep) holds the stream while the host queues the
    calls, so the events time the device's work and not the host's launch
    overhead (a wrapper's checks and allocations can take longer than its
    kernel). The spin grows 4x while it ends before the last call is
    queued; a call that waits for the device (a synchronous copy of a host
    scalar) drains it however long it is, and is then timed with the
    host's share, as without the spin. So do reps calls that launch more
    kernels than the device's launch queue holds: the host blocks in the
    launch until the spin ends (the 1080p SVGF chain's ~560 kernels a call
    are timed with reps=1)."""
    import torch
    for _ in range(3):
        fn()
    for spin in (1 << 24, 1 << 26, 1 << 28):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        drained = start.query()  # the spin ended before the last call was queued
        torch.cuda.synchronize()
        if not drained:
            break
    return start.elapsed_time(end) / reps


def recorded_calls(scene, cfg, tables, rays) -> list:
    """Every traversal call one frame of trace_paths makes, in order, as
    (tracer entry, positional args, keyword args), each passed on to the
    kernels; tensor arguments are cloned."""
    import torch
    from tpuray_torch.integrator import path_tracer as pt

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (list, tuple)):
            return type(x)(clone(v) for v in x)
        return x

    calls = []

    def recording(name):
        fn = getattr(pt.KERNELS, name)

        def call(*a, **k):
            calls.append((name, clone(a), dict(k)))
            return fn(*a, **k)
        return call

    tracer = pt.Tracer(**{f.name: recording(f.name)
                          for f in dataclasses.fields(pt.Tracer)})
    orig, d, px, py = rays
    pt.trace_paths(scene, orig, d, px, py, 0, cfg, common_origin=True,
                   tracer=tracer, tables=tables)
    return calls


# the five per-ray-origin walks of a depth-2 frame (trace_paths' calls 1-5,
# after the primaries), each K3 on a single tree
SEPARATE_WALKS = ("bounce-0 env shadow", "bounce-0 point shadow",
                  "bounce-0 bounce ray", "bounce-1 env shadow",
                  "bounce-1 point shadow")
MIS_WALKS = ("bounce-0 light shadow", "bounce-0 BSDF continuation",
             "bounce-1 bounce ray", "bounce-1 light shadow",
             "bounce-1 BSDF continuation")


def k1_rays(dev, size: int = W) -> list:
    """[(name, orig (1, 3), d (N, 3))]: K1's ray sets, N = size^2, all
    closest-hit with t_max = INF as the frame traces them: the camera
    primaries of the default view (OrbitCamera()) and of a view low over
    the ground (pitch 2 degrees, rays that graze the ground quad), both in
    32x32 tile order (camera_rays), and random directions from one origin
    (tests/test_torch_gpu.py's: toward seeded points about the sphere), for
    which a warp's lanes part at once."""
    import numpy as np
    import torch
    from tpuray_torch.render.renderer import camera_rays
    from tpuray_torch.scene.camera import OrbitCamera
    out = []
    for name, pitch in (("default view", 10.0), ("grazing view", 2.0)):
        cam = OrbitCamera(width=size, height=size, pitch_deg=pitch).snapshot(dev)
        orig, d, _, _ = camera_rays(cam, size, size)
        out.append((name, orig[:1].contiguous(), d))
    rng = np.random.default_rng(10)
    o = np.asarray([[0.0, 0.3, 2.0]], np.float32)
    d = (rng.random((size * size, 3)).astype(np.float32) - 0.5) * 1.5 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    out.append(("random directions", torch.from_numpy(o).to(dev),
                torch.from_numpy(d).to(dev)))
    return out


def k3_walks(scene, cfg, tables, rays) -> list:
    """[(name, (orig, d, t_max, any_hit))] of the five K3 walks of one
    separate-walk and one MIS frame, each t_max a per-ray tensor, so that
    every checkout times the same work (older ones copy a float t_max to
    the card and wait for it)."""
    import torch
    walks = []
    for path, cfg_p, names in (
            ("separate-walk", dataclasses.replace(cfg, fused_secondary=False),
             SEPARATE_WALKS),
            ("MIS", dataclasses.replace(cfg, integrator="mis"), MIS_WALKS)):
        calls = recorded_calls(scene, cfg_p, tables, rays)
        if [c[0] for c in calls] != ["packets"] + ["batched"] * 5:
            raise AssertionError(f"{path} frame traversal calls {[c[0] for c in calls]}")
        for (_, args, _), name in zip(calls[1:], names):
            orig, d, tm, any_hit = args[1:5]
            if not isinstance(tm, torch.Tensor):
                tm = torch.full((d.shape[0],), tm, device=d.device)
            walks.append((f"{path} {name}", (orig, d, tm, any_hit)))
    return walks


def k7_cases(scene, prim_idx) -> list:
    """[(name, table, idx)]: chip_smoke.py's phase-13 inputs of K7, the
    triangle table (T, 26) at the clamped primary hit indices prim_idx, the
    material table (M, 18) at those hits' mat_id, and an (11k, 44) table
    at as many random indices (seeded)."""
    import torch
    from tpuray_torch.integrator.gather_tables import fetch_tri, pack_scene_tables
    dev = prim_idx.device
    pk = pack_scene_tables(scene)
    idx = prim_idx.clamp_min(0).to(torch.int32).contiguous()
    tri = pk.tri_table.contiguous()
    mat_id = fetch_tri(tri, idx).mat_id.to(torch.int32).contiguous()
    gen = torch.Generator(device=dev).manual_seed(13)
    big = torch.rand((11_000, 44), generator=gen, device=dev) * 16.0 - 8.0
    rnd = torch.randint(0, 11_000, (idx.numel(),), generator=gen, device=dev,
                        dtype=torch.int32)
    return [("triangle rows at the primary hits", tri, idx),
            ("material rows at the primary hits", pk.mat_table.contiguous(), mat_id),
            ("(11k, 44) at random indices", big, rnd)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--parts", default="k1,k2,k3,k6,k7")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    sys.path.insert(0, str(args.tree.resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("traversal_times needs a CUDA device")
    from tpuray_torch.integrator import path_tracer as pt
    from tpuray_torch.integrator.intersect import INF
    from tpuray_torch.kernels import build
    from tpuray_torch.kernels import gather as kg
    from tpuray_torch.kernels import trace as kt
    from tpuray_torch.kernels import trace_chunked as ktc
    from tpuray_torch.render.renderer import camera_rays
    from tpuray_torch.scene.camera import OrbitCamera
    from tpuray_torch.scene.config import RenderConfig
    from tpuray_torch.scene.procedural import make_large_scene, make_test_scene

    import tpuray_torch
    print(f"tree {Path(tpuray_torch.__file__).parents[1]}; device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    build.load()
    dev = torch.device("cuda")
    cfg = RenderConfig(width=W, height=H, compact_frac=0.0, compact_auto=False)
    times = {}

    def timed(name, fn):
        times[name] = kernel_ms(fn)
        print(f"{name}: {times[name]:.4f} ms", flush=True)

    scene = make_test_scene(subdiv=5, env_width=512, device=dev)
    tables = kt.pack_scene(scene.bvh, scene.triangles)
    rays = camera_rays(OrbitCamera(width=W, height=H).snapshot(dev), H, W)
    orig, d = rays[0], rays[1]
    if "k1" in parts:
        inf_rays = torch.full((d.shape[0],), INF, device=dev)
        for name, o1, d1 in k1_rays(dev):
            timed(f"K1 {name}", lambda o1=o1, d1=d1: kt.trace_packets(
                tables, o1, d1, INF, common_origin=True))
            timed(f"K1 {name}, t_max per ray", lambda o1=o1, d1=d1: kt.trace_packets(
                tables, o1, d1, inf_rays, common_origin=True))
    if "k2" in parts:
        _, o2, dirs, tms, ah = recorded_calls(scene, cfg, tables, rays)[1][1]
        timed("K2 bounce 0, 3 classes", lambda: kt.trace_multi(tables, o2, dirs, tms, ah))
        for c, name in enumerate(("bounce ray", "env shadow", "point shadow")):
            timed(f"K3 bounce-0 {name} alone", lambda c=c: kt.trace_batched(
                tables, o2, dirs[c], tms[c], ah[c]))
    if "k3" in parts:
        walks = k3_walks(scene, cfg, tables, rays)
        for name, a in walks:
            timed(f"K3 {name}", lambda a=a: kt.trace_batched(tables, *a))
        for path in ("separate-walk", "MIS"):
            mine = [a for name, a in walks if name.startswith(path)]
            timed(f"K3 {path} frame, 5 walks",
                  lambda mine=mine: [kt.trace_batched(tables, *a) for a in mine])
    if "k3split" in parts:  # what a K3 walk's time is made of
        for name, (o, d3, tm, ah) in k3_walks(scene, cfg, tables, rays):
            live = tm > 0
            dead = torch.zeros_like(tm)
            packed = [x[live].contiguous() for x in (o, d3, tm)]
            timed(f"K3 {name}, every lane dead",
                  lambda o=o, d3=d3, dead=dead, ah=ah: kt.trace_batched(tables, o, d3, dead, ah))
            timed(f"K3 {name}, its {int(live.sum())} live rays alone",
                  lambda packed=packed, ah=ah: kt.trace_batched(tables, *packed, ah))
    if "k7" in parts:
        prim_idx = kt.trace_packets(tables, orig, d, INF, common_origin=True)[1]
        for name, table, idx in k7_cases(scene, prim_idx):
            timed(f"K7 {name}", lambda table=table, idx=idx: kg.onehot_gather(table, idx))
            timed(f"table[idx] {name}", lambda table=table, idx=idx: table[idx])
    del scene, tables

    cam_l = OrbitCamera(width=W, height=H, radius=4.0).snapshot(dev)
    for tag, subdiv, walks in (("131k", 4, range(6)), ("524k", 5, (0, 3))):
        if "k6" not in parts:
            break
        large = make_large_scene(n_spheres=25, subdiv=subdiv, env_width=512, device=dev)
        forest = pt.pack_traversal(large)
        calls = recorded_calls(large, cfg, forest, camera_rays(cam_l, H, W))
        names = ("primaries", "bounce-0 env shadow", "bounce-0 point shadow",
                 "bounce-0 bounce ray", "bounce-1 env shadow", "bounce-1 point shadow")
        for k in walks:
            args = list(calls[k][1][1:])  # orig, d, t_max, ...
            timed(f"K6 {tag} {names[k]}",
                  lambda args=args: ktc.trace_chunked(forest, *args))
            if not isinstance(args[2], torch.Tensor):
                per_ray = [*args[:2], torch.full((args[1].shape[0],), args[2], device=dev),
                           *args[3:]]
                timed(f"K6 {tag} {names[k]}, t_max per ray",
                      lambda per_ray=per_ray: ktc.trace_chunked(forest, *per_ray))
        del large, forest, calls
    print(json.dumps(times), flush=True)


if __name__ == "__main__":
    main()
