"""Device times of the traversal kernels K1, K2, K3 and K6 on the main
paths' rays, to compare two versions of the kernels in one call.

    python3 tpuray_torch/traversal_times.py [--tree DIR]

--tree DIR imports tpuray_torch from DIR, a checkout of another commit
(for example the parent, unpacked with `git archive` into the git-ignored
build/), so the same rays go through that version's kernels; the script
calls only entry points that every version since slice 3 has. The rays:
the 800x800 camera primaries of the test scene (20,482 triangles; K1),
the default view's bounce-0 classes (K2, and K3 on each class alone), the
separate-walk bounce-0 bounce ray (K3), the six K6 walks of a 131k-forest
frame (primaries, bounce-0 env shadow, point shadow and bounce ray,
bounce-1 env and point shadow) and the 524k forest's primaries and
bounce-0 bounce ray. Each time is the mean device time of 20 launches
between two CUDA events, after 3 warm-ups, queued behind a spin kernel so
that the host's launch overhead does not count (kernel_ms, which
chip_smoke.py and denoise_times.py use too).
Prints one line per walk, then one JSON line {walk: ms}. Needs a CUDA
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
    host's share, as without the spin."""
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("traversal_times needs a CUDA device")
    from tpuray_torch.integrator import path_tracer as pt
    from tpuray_torch.integrator.intersect import INF
    from tpuray_torch.kernels import build
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
    inf_rays = torch.full((d.shape[0],), INF, device=dev)  # a float t_max waits on a copy
    timed("K1 primaries", lambda: kt.trace_packets(tables, orig, d, inf_rays,
                                                   common_origin=True))
    _, o2, dirs, tms, ah = recorded_calls(scene, cfg, tables, rays)[1][1]
    timed("K2 bounce 0, 3 classes", lambda: kt.trace_multi(tables, o2, dirs, tms, ah))
    for c, name in enumerate(("bounce ray", "env shadow", "point shadow")):
        timed(f"K3 bounce-0 {name} alone", lambda c=c: kt.trace_batched(
            tables, o2, dirs[c], tms[c], ah[c]))
    sep = recorded_calls(scene, dataclasses.replace(cfg, fused_secondary=False),
                         tables, rays)
    timed("K3 separate-walk bounce-0 bounce ray",
          lambda: kt.trace_batched(tables, *sep[3][1][1:]))
    del scene, tables, sep

    cam_l = OrbitCamera(width=W, height=H, radius=4.0).snapshot(dev)
    for tag, subdiv, walks in (("131k", 4, range(6)), ("524k", 5, (0, 3))):
        large = make_large_scene(n_spheres=25, subdiv=subdiv, env_width=512, device=dev)
        forest = pt.pack_traversal(large)
        calls = recorded_calls(large, cfg, forest, camera_rays(cam_l, H, W))
        names = ("primaries", "bounce-0 env shadow", "bounce-0 point shadow",
                 "bounce-0 bounce ray", "bounce-1 env shadow", "bounce-1 point shadow")
        for k in walks:
            args = list(calls[k][1][1:])  # orig, d, t_max, ...
            if not isinstance(args[2], torch.Tensor):  # a float t_max waits on a copy
                args[2] = torch.full((args[1].shape[0],), args[2], device=dev)
            timed(f"K6 {tag} {names[k]}",
                  lambda args=args: ktc.trace_chunked(forest, *args))
        del large, forest, calls
    print(json.dumps(times), flush=True)


if __name__ == "__main__":
    main()
