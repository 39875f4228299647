"""Command-line entry point (counterpart of tpuray/cli/main.py).

Headless progressive rendering to PNG with debug-view selection and
FrameState checkpoints, a supervised render loop that restores and replays
after a device fault (--elastic), an orbiting-camera PNG sequence, the
differentiable material recovery demo, the browser viewer and the
benchmark (tpuray_torch/bench.py), on the CUDA card by default (--device
cpu runs on the CPU).

Examples:
  python -m tpuray_torch.cli.main render --frames 8 --out out.png
  python -m tpuray_torch.cli.main render --scene reference --asset-root DIR
  python -m tpuray_torch.cli.main render --elastic ck.npz --checkpoint-every 4
  python -m tpuray_torch.cli.main render --frames 16 --trace traces/
  python -m tpuray_torch.cli.main animate --frames 24 --every 4
  python -m tpuray_torch.cli.main train --steps 20 --out-prefix fit
  python -m tpuray_torch.cli.main view --port 8008
  BENCH_FULL=1 python -m tpuray_torch.cli.main bench
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

_VIEWS = {
    "1spp": "PATH_TRACING_1SPP", "reprojected": "SVGF_REPROJECTED",
    "variance": "SVGF_VARIANCE", "atrous": "SVGF_ATROUS",
    "modulate": "SVGF_MODULATE", "taa": "TAA", "final": "FINAL",
    "accum": "ACCUMULATE_COLOR",
}
_SCENES = ["reference", "table", "procedural"]


def _build_scene(name: str, quirks: bool):
    """The named scene on the host; reference and table load their OBJ from
    the asset roots (FileNotFoundError when it is absent)."""
    if name == "reference":
        from tpuray_torch.scene.builder import reference_default_scene
        return reference_default_scene(reference_quirks=quirks)
    if name == "table":
        from tpuray_torch.scene.builder import ObjectSpec, build_scene
        return build_scene(
            [ObjectSpec(path="models/table.obj",
                        material=dict(base_color=(0.7, 0.5, 0.3), roughness=0.4))],
            reference_quirks=quirks)
    from tpuray_torch.scene.procedural import make_test_scene
    return make_test_scene(subdiv=3)


def _config(args, **fields):
    from tpuray_torch.scene.config import RenderConfig
    cfg = RenderConfig.load(args.config) if args.config else RenderConfig()
    return cfg.replace(width=args.size, height=args.size, **fields)


def _frame(r, camera, metrics) -> None:
    """One frame, timed to its end (the copy of one pixel waits for it)."""
    t0 = time.perf_counter()
    out = r.step(camera)
    out.final[:1, :1].cpu()
    metrics.record(time.perf_counter() - t0)


def cmd_render(args) -> int:
    from tpuray_torch.io.image import write_png
    from tpuray_torch.render.renderer import Renderer
    from tpuray_torch.scene.camera import OrbitCamera
    from tpuray_torch.scene.config import DebugView
    from tpuray_torch.utils.metrics import FrameMetrics, frame_records, profile_trace

    cfg = _config(args, max_tracing_depth=args.depth,
                  reference_quirks=args.reference_quirks)
    scene = _build_scene(args.scene, args.reference_quirks)
    cam = OrbitCamera(width=cfg.width, height=cfg.height,
                      yaw_deg=args.yaw, pitch_deg=args.pitch, radius=args.radius)
    r = Renderer(scene, cfg, device=args.device)
    if args.resume:
        from tpuray_torch.utils.checkpoint import load_frame_state
        r.restore(load_frame_state(args.resume, r.device))

    metrics = FrameMetrics(cfg.width, cfg.height, cfg.max_tracing_depth)
    with profile_trace(args.trace) if args.trace else contextlib.nullcontext():
        if args.elastic:
            _render_elastic(r, cam.snapshot(), args, metrics)
        else:
            for _ in range(args.frames):
                _frame(r, cam.snapshot(), metrics)
    print(metrics.summary(), file=sys.stderr)
    if args.trace:
        path = os.path.join(args.trace, "frame_records.json")
        with open(path, "w") as f:
            json.dump(frame_records()[-args.frames:], f)
        print(f"wrote a Chrome trace of the frames and {path} into {args.trace}",
              file=sys.stderr)

    write_png(args.out, r.display_image(DebugView[_VIEWS[args.view]]))
    print(f"wrote {args.out} ({cfg.width}x{cfg.height}, {args.frames} frames, "
          f"view={args.view})", file=sys.stderr)
    if args.checkpoint:
        from tpuray_torch.utils.checkpoint import save_frame_state
        save_frame_state(args.checkpoint, r.state)
        print(f"saved state -> {args.checkpoint}", file=sys.stderr)
    if args.dump_all_views:
        base = args.out.rsplit(".", 1)[0]
        for name, enum_name in _VIEWS.items():
            write_png(f"{base}_{name}.png", r.display_image(DebugView[enum_name]))
    return 0


def _render_elastic(r, snap, args, metrics) -> None:
    """The supervised loop (utils/elastic.py): a device fault restores the
    newest checkpoint and replays. Each frame is a function of the state
    and the camera: the config as given (no compaction tuning between
    frames) and the static-camera branch from the state's view matrix, so a
    resumed run is bit for bit an uninterrupted one. Each frame index is
    recorded once, however often it is replayed."""
    import torch

    from tpuray_torch.render.renderer import render_frame, still_camera
    from tpuray_torch.utils.elastic import run_elastic
    from tpuray_torch.utils.metrics import FRAME, span

    view_proj = snap.view_proj.numpy()
    camera = snap.to(r.device)
    seen = set()

    @torch.no_grad()
    def frame_fn(state, frame):
        t0 = time.perf_counter()
        with span(FRAME):
            static = still_camera(r.device, state.frame_idx, view_proj,
                                  state.prev_view_proj.cpu().numpy())
            state, out = render_frame(r.scene, camera, state, r.cfg, r.cfg.height,
                                      r.cfg.width, tracer=r.tracer, tables=r.tables,
                                      pk=r.pk, static_camera=static)
        out.final[:1, :1].cpu()  # the frame's end, as _frame times it
        r.last_outputs = out
        if frame not in seen:
            seen.add(frame)
            metrics.record(time.perf_counter() - t0)
        return state

    state, stats = run_elastic(frame_fn, r.state, args.frames, args.elastic,
                               checkpoint_every=args.checkpoint_every)
    r.restore(state)
    print(f"elastic: {stats.frames_done} frames, {stats.faults} faults, "
          f"{stats.restores} restores, {stats.checkpoints} checkpoints",
          file=sys.stderr)


def cmd_animate(args) -> int:
    """Step an orbiting camera each frame and write a PNG sequence (the
    original renderer's mouse-drag orbit, headless)."""
    from tpuray_torch.io.image import write_png
    from tpuray_torch.render.renderer import Renderer
    from tpuray_torch.scene.camera import OrbitCamera
    from tpuray_torch.scene.config import DebugView
    from tpuray_torch.utils.metrics import FrameMetrics

    cfg = _config(args)
    scene = _build_scene(args.scene, False)
    cam = OrbitCamera(width=cfg.width, height=cfg.height,
                      yaw_deg=args.yaw, pitch_deg=args.pitch, radius=args.radius)
    r = Renderer(scene, cfg, device=args.device)
    metrics = FrameMetrics(cfg.width, cfg.height, cfg.max_tracing_depth)
    view = DebugView[_VIEWS[args.view]]
    for i in range(args.frames):
        cam.rotate(args.deg_per_frame, 0.0)
        _frame(r, cam.snapshot(), metrics)
        if i % args.every == 0:
            write_png(f"{args.out_prefix}_{i:04d}.png", r.display_image(view))
    print(metrics.summary(), file=sys.stderr)
    return 0


def cmd_train(args) -> int:
    """Differentiable material recovery: render the scene, perturb every
    material's base_color (* 0.4 + 0.3), then take --steps Adam steps at
    --lr on every material and light leaf towards the first image; write
    the target and the fit as PNGs."""
    import torch

    from tpuray_torch.io.image import write_png
    from tpuray_torch.render.renderer import tonemap
    from tpuray_torch.scene.camera import OrbitCamera
    from tpuray_torch.scene.config import RenderConfig
    from tpuray_torch.train.optimize import make_train_step, render_flat, split_trainable

    cfg = RenderConfig(width=args.size, height=args.size, max_tracing_depth=args.depth)
    scene = _build_scene(args.scene, False)
    cam = OrbitCamera(width=args.size, height=args.size).snapshot()

    params, rebuild = split_trainable(scene, device=args.device)
    with torch.no_grad():
        target = render_flat(rebuild(params), cam, cfg, args.size, args.size, 0)
        base = params["materials"].base_color
        params["materials"] = params["materials"].replace(
            base_color=(base * 0.4 + 0.3).requires_grad_(True))
    init, step = make_train_step(rebuild, cfg, args.size, args.size,
                                 lambda leaves: torch.optim.Adam(leaves, lr=args.lr))
    state = init(params)
    loss = None
    for i in range(args.steps):
        state, loss = step(state, target, cam, 0)
        if i % max(1, args.steps // 10) == 0:
            print(f"step {i}: loss {float(loss):.6f}", file=sys.stderr)
    with torch.no_grad():
        final = render_flat(rebuild(state.params), cam, cfg, args.size, args.size, 0)
    write_png(f"{args.out_prefix}_target.png", tonemap(target).cpu().numpy())
    write_png(f"{args.out_prefix}_fit.png", tonemap(final).cpu().numpy())
    print(f"final loss {float(loss):.6f}", file=sys.stderr)
    return 0


def cmd_view(args) -> int:
    """Serve the browser viewer until Ctrl-C; prints its URL (the port
    resolved, so --port 0 takes a free one)."""
    from tpuray_torch.viewer.server import ViewerServer

    cfg = _config(args, reference_quirks=args.reference_quirks)
    scene = _build_scene(args.scene, args.reference_quirks)
    server = ViewerServer(scene, cfg, host=args.host, port=args.port,
                          device=args.device)
    server.start()
    server.serve_forever()
    return 0


def cmd_bench(args) -> int:
    """bench.py's metrics through the port (tpuray_torch/bench.py); its
    budget reads BENCH_BUDGET_S and BENCH_FULL."""
    from tpuray_torch import bench
    return bench.main(["--device", args.device])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpuray_torch")
    p.add_argument("--asset-root", default=None,
                   help="extra asset root searched before the built-in one "
                        "(also settable via $TPURAY_ASSET_ROOT)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_option(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device (cuda raises without a CUDA card)")

    pr = sub.add_parser("render", help="progressive render to PNG")
    pr.add_argument("--scene", default="procedural", choices=_SCENES)
    pr.add_argument("--frames", type=int, default=8)
    pr.add_argument("--size", type=int, default=256)
    pr.add_argument("--depth", type=int, default=2)
    pr.add_argument("--view", default="final", choices=sorted(_VIEWS))
    pr.add_argument("--out", default="render.png")
    pr.add_argument("--config", default=None, help="RenderConfig JSON file")
    pr.add_argument("--yaw", type=float, default=0.0)
    pr.add_argument("--pitch", type=float, default=10.0)
    pr.add_argument("--radius", type=float, default=2.0)
    pr.add_argument("--checkpoint", default=None, help="save FrameState npz")
    pr.add_argument("--resume", default=None, help="load FrameState npz")
    pr.add_argument("--elastic", default=None, metavar="CKPT",
                    help="supervised loop: restore and replay after a device fault")
    pr.add_argument("--checkpoint-every", type=int, default=8)
    pr.add_argument("--reference-quirks", action="store_true")
    pr.add_argument("--dump-all-views", action="store_true")
    pr.add_argument("--trace", default=None, metavar="DIR",
                    help="write a Chrome trace of the frames (torch.profiler, with the "
                         "program's tpuray.* spans) and their counters "
                         "(frame_records.json) into DIR")
    device_option(pr)
    pr.set_defaults(fn=cmd_render)

    pt = sub.add_parser("train", help="differentiable material recovery demo")
    pt.add_argument("--scene", default="procedural", choices=_SCENES)
    pt.add_argument("--steps", type=int, default=20)
    pt.add_argument("--size", type=int, default=64)
    pt.add_argument("--depth", type=int, default=1)
    pt.add_argument("--lr", type=float, default=0.05)
    pt.add_argument("--out-prefix", default="train")
    device_option(pt)
    pt.set_defaults(fn=cmd_train)

    pa = sub.add_parser("animate", help="orbiting-camera PNG sequence")
    pa.add_argument("--scene", default="procedural", choices=_SCENES)
    pa.add_argument("--frames", type=int, default=24)
    pa.add_argument("--size", type=int, default=256)
    pa.add_argument("--deg-per-frame", type=float, default=1.5)
    pa.add_argument("--every", type=int, default=1, help="write every k-th frame")
    pa.add_argument("--view", default="final", choices=sorted(_VIEWS))
    pa.add_argument("--out-prefix", default="anim")
    pa.add_argument("--config", default=None)
    pa.add_argument("--yaw", type=float, default=0.0)
    pa.add_argument("--pitch", type=float, default=10.0)
    pa.add_argument("--radius", type=float, default=2.0)
    device_option(pa)
    pa.set_defaults(fn=cmd_animate)

    pv = sub.add_parser("view", help="interactive browser viewer")
    pv.add_argument("--scene", default="procedural", choices=_SCENES)
    pv.add_argument("--size", type=int, default=400)
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8008)
    pv.add_argument("--config", default=None)
    pv.add_argument("--reference-quirks", action="store_true")
    device_option(pv)
    pv.set_defaults(fn=cmd_view)

    pb = sub.add_parser("bench", help="run the benchmark")
    device_option(pb)
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    if args.asset_root:
        from tpuray_torch.io.filesystem import add_root
        add_root(args.asset_root)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
