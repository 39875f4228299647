"""One run of one cell: set-up, warm-up, the measured window, the traced
frames or steps (--trace 1), the check, and the result.

run.py calls run_cell after it has made sure of the card; the tests call
it on the CPU at a small size.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import torch

from portbench import check, clients, context, sharded, spec, stats, traceread

FORBIDDEN = ("jax", "jaxlib", "flax", "tpuray")
GIB = float(1 << 30)


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name, compared whole, is jax's,
    jaxlib's, flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Ctx:
    """What a per-layer reader (metrics/<name>.py: read(ctx)) can read."""

    unit: str                 # "frame" or "step"
    units: int                # frames or steps in the traced session
    unit_wall_s: float        # unprofiled wall seconds a unit (the window's)
    trace: traceread.Trace    # the traced session's device and host operations
    counts: list[dict]        # per traced unit (clients.<kind>.counts)
    iterations: int           # a-trous iterations a frame
    scene_build_s: float


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t0: float | None = None, bench: dict | None = None,
             trace_units: int | None = None) -> tuple[dict, list[str]]:
    """-> (the result's object, its check lines for stderr)."""
    t0 = time.perf_counter() if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    bench = bench or spec.benchmark()
    w = spec.cell(name, bench)
    conf, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    drv = clients.CLIENTS[traffic["kind"]](conf, traffic, seed, device)
    drv.warm_up()
    setup_s = time.perf_counter() - t0

    smi_before = context.smi() if cuda else []
    times = []
    paused = 0.0  # the check's copies, left out of the window's clock
    start = last = time.perf_counter()
    while True:
        p = drv.timed()
        now = time.perf_counter()
        times.append(now - last - p)
        paused += p
        last = now
        if now - start - paused >= seconds:
            break
    window_s = last - start - paused
    if hasattr(drv, "memory_peak"):  # a client over ranks: the largest rank's
        peak = drv.memory_peak()
    else:
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    smi_after = context.smi() if cuda else []
    bad_mods = forbidden_modules()
    if bad_mods:
        raise SystemExit(f"forbidden modules loaded: {bad_mods}")

    result = dict(correct=False, attempted=len(times), failed=0, metrics={})
    per_layer = spec.metrics_of(name, bench, "per_layer")
    if trace:
        n = trace_units or traffic["trace_units"]
        recs: list = []

        def session():
            recs.clear()
            recs.extend(drv.untimed() for _ in range(n))

        prof, traced_wall, sessions = traceread.profiled(session)
        tr = traceread.Trace.of(prof)
        del prof
        ctx = Ctx(unit=drv.unit, units=n, unit_wall_s=window_s / len(times),
                  trace=tr, counts=[drv.counts(r) for r in recs],
                  iterations=drv.cfg.num_atrous_iterations, scene_build_s=drv.scene_build_s)
        recs.clear()
        for m in per_layer:
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = dict(device_ops=tr.top_ops(), idle_gaps=tr.idle_gaps())
        trace_info = dict(busy_s=tr.busy_us() / 1e6, window_s=traced_wall)
        context.emit("trace", dict(units=n, sessions=sessions, **trace_info))
    values = {drv.rate_metric: stats.window_rate(window_s, len(times)),
              drv.tail_metric: stats.percentile(times, 95) * 1e3,
              "peak_mem_gib": peak / GIB, "setup_s": setup_s}
    if not trace:
        for m in spec.metrics_of(name, bench, "end_to_end"):
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result["device"] = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name() if cuda else "cpu",
        count=getattr(drv, "chips", 1), memory_peak_bytes=peak)
    if trace:
        result["device"].update(trace_info)
    quarters = [times[len(times) * q // 4:len(times) * (q + 1) // 4] for q in range(4)]
    context.emit("window", dict(
        units=len(times), window_s=window_s, check_copy_s=paused,
        scene_build_s=drv.scene_build_s,
        unit_ms_by_quarter=[1e3 * sum(q) / len(q) for q in quarters if q],
        unit_ms_deciles=[1e3 * stats.percentile(times, q) for q in range(10, 100, 10)],
        **values))
    context.emit("scene", dict(triangles=conf["triangles"], **drv.scene_context()))
    context.emit("smi_before_window", smi_before)
    context.emit("smi_after_window", smi_after)

    # the check: after the window and the peak read (the peak covers
    # set-up and the window), the program's state dropped; what the check
    # reads is in host memory
    samples = drv.check_inputs()
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check_numbers(name, drv, traffic, samples, device)
    lim = spec.limits(name, traffic["kind"])
    ok, shown = check.verdict(numbers, lim["limits"])
    result["correct"] = ok
    result["checks"] = shown
    lines = [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in shown.items()]
    bad_mods = forbidden_modules()
    if bad_mods:
        raise SystemExit(f"forbidden modules loaded: {bad_mods}")
    return result, lines


def check_numbers(name: str, drv, traffic: dict, samples, device) -> dict:
    """The check's numbers of what the client kept, the reference built
    anew from the same inputs."""
    from portbench import scenes
    from portbench.reference import train as rt
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference in float32
    torch.backends.cudnn.allow_tf32 = False
    ref_scene = scenes.reference_scene(drv.conf, drv.made, device)
    cfg = clients.ref_cfg(drv.cfg)
    if traffic["kind"] == "orbit":
        lim = spec.limits(name, traffic["kind"])
        return check.orbit_numbers(ref_scene, cfg, samples, lim["rtol"], lim["atol"], device)
    if traffic["kind"] == "orbit_sharded":
        lim = spec.limits(name, traffic["kind"])
        return sharded.check_numbers(ref_scene, cfg, samples, lim["rtol"], lim["atol"], device)
    cam = {k: torch.as_tensor(v, device=device) for k, v in drv.arrays.items()}
    with torch.no_grad():
        paths = rt.render_paths(ref_scene, cam, cfg, 0)
    context.emit("scene_reference", dict(primary_hit_share=float(paths.valid.float().mean())))
    target = paths.color.reshape(cfg.height, cfg.width, 3)
    p0 = drv.initial_leaves(device)
    ref = rt.run_steps(ref_scene, p0, target, cam, cfg, traffic["lr"], len(samples["loss"]))
    numbers = check.train_numbers(samples, ref, p0)
    # the step kept from the window, from the program's leaves and Adam's
    # state before it
    prog, w0, adam = check.window_program(samples["window"], rt.B1, device)
    ref = rt.run_steps(ref_scene, w0, target, cam, cfg, traffic["lr"], 1, adam=adam)
    context.emit("window_step", dict(index=samples["window"]["index"]))
    numbers.update({f"window_{k}": v for k, v in check.train_numbers(prog, ref, w0).items()})
    return numbers
