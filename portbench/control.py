"""The readings that the check's limits are set from (not run by the
benchmark's runs).

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--seconds 2]
        [--out FILE]

For each seed, in one process: the cell's set-up, warm-up and a short
window, then
- the program's numbers (the lower readings), as a run computes them;
- the control's: the reference put in the program's place with what each
  stage hands on rounded to bfloat16 (the next precision below the
  float32 the configuration states), checked by the same numbers;
- on a train cell, the fault of half the batch left out (the loss the
  mean over every other pixel), planted in the reference put in the
  program's place; for the step kept from the window, each side takes
  one step from the program's leaves and Adam's state before it.
Prints one JSON line a seed and writes them all to --out.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import torch

from portbench import check, clients, scenes, spec
from portbench.reference import frame as rf
from portbench.reference import train as rt
from portbench.reference.gbuffer import GBuffer


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def as_program(out: dict, nxt: dict) -> tuple:
    """A reference frame's outputs shaped as the program's FrameOutputs,
    and its next state."""
    svgf = SimpleNamespace(**{k: out[k] for k in (
        "reprojected", "reprojected_var", "variance_illum", "variance_var", "atrous",
        "atrous_var", "history_tap", "history_tap_var", "modulated", "taa", "moments",
        "history_len")})
    o = SimpleNamespace(pt_color=out["pt_color"], accum_color=out["pt_color"], svgf=svgf,
                        gbuffer=GBuffer(*out["gbuffer"]), final=out["final"])
    return o, nxt


def readings(name: str, seed: int, seconds: float, device: str = "cuda",
             traffic_override: dict | None = None, bench: dict | None = None) -> dict:
    bench = bench or spec.benchmark()
    w = spec.cell(name, bench)
    conf, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    traffic = dict(traffic, **(traffic_override or {}))
    drv = clients.CLIENTS[traffic["kind"]](conf, traffic, seed, device)
    drv.warm_up()
    start = time.perf_counter()
    n = 0
    while n == 0 or time.perf_counter() - start < seconds:
        drv.timed()
        n += 1
    samples = drv.check_inputs()
    drv.release()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from portbench.harness import check_numbers
    program = check_numbers(name, drv, traffic, samples, device)
    ref_scene = scenes.reference_scene(conf, drv.made, device)
    cfg = clients.ref_cfg(drv.cfg)
    out = dict(workload=name, seed=seed, units=n, program=program)
    if traffic["kind"] in ("orbit", "orbit_sharded"):
        lim = spec.limits(name, traffic["kind"])
        ctl = []
        for s in samples:
            d = check.record_on(s, device)
            o, nxt = as_program(*rf.render_frame(ref_scene, d["camera"], d["state"], cfg,
                                                 store=bf16))
            ctl.append(dict(s, out=o, next=nxt))
        out["control"] = check.orbit_numbers(ref_scene, cfg, ctl, lim["rtol"], lim["atol"],
                                             device)
    else:
        cam = {k: torch.as_tensor(v, device=device) for k, v in drv.arrays.items()}
        target = rt.render_flat(ref_scene, cam, cfg, 0).detach()
        p0 = drv.initial_leaves(device)
        steps = len(samples["loss"])
        ref = rt.run_steps(ref_scene, p0, target, cam, cfg, traffic["lr"], steps)
        ctl = rt.run_steps(ref_scene, p0, target, cam, cfg, traffic["lr"], steps, store=bf16)
        half = torch.arange(0, cfg.height * cfg.width, 2, device=device)
        flt = rt.run_steps(ref_scene, p0, target, cam, cfg, traffic["lr"], steps, rows=half)
        out["control"] = check.train_numbers(ctl, ref, p0)
        out["fault_half_batch"] = check.train_numbers(flt, ref, p0)
        out["detail"] = {k: check.train_detail(v, ref, p0) for k, v in
                         (("program", samples), ("control", ctl), ("fault_half_batch", flt))}
        # the step kept from the window, each side from the program's state
        # before it
        prog, w0, adam = check.window_program(samples["window"], rt.B1, device)
        lr = traffic["lr"]
        ref = rt.run_steps(ref_scene, w0, target, cam, cfg, lr, 1, adam=adam)
        ctl = rt.run_steps(ref_scene, w0, target, cam, cfg, lr, 1, adam=adam, store=bf16)
        flt = rt.run_steps(ref_scene, w0, target, cam, cfg, lr, 1, adam=adam, rows=half)
        for key, side in (("control", ctl), ("fault_half_batch", flt)):
            out[key].update({f"window_{k}": v for k, v in
                             check.train_numbers(side, ref, w0).items()})
        out["detail"].update({f"window_{k}": check.train_detail(v, ref, w0) for k, v in
                              (("program", prog), ("control", ctl), ("fault_half_batch", flt))})
        out["window_index"] = samples["window"]["index"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 1
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(args.workload, seed, args.seconds)
        print(json.dumps(r), flush=True)
        rows.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
