"""What decides `correct`: the program's outputs held against the
reference (reference/), each number beside its limit.

A frame is checked stage by stage, each reference stage on the program's
inputs to that stage: the trace and shading from the frame's state and
camera (the 1-spp image; the G-buffer, which holds the first hits: sky
depth where a ray missed), K4's
reprojection and variance on the program's image and G-buffer, the
a-trous chain on the program's variance output, modulate, TAA, and the
state the program carries to the next frame. A number is the share of
pixels where some value of the stage lies outside rtol and atol of the
reference's; the frame's number is the largest over the frames checked.
The traversal's ties and compaction's grazing shadows flip isolated
pixels of the trace; each later stage then sees the same inputs on both
sides.

A train step is checked by the first step's loss, the first gradient as
the optimizer holds it (by the worst leaf) and the parameters' change
after the first steps (the median leaf's): gaps of norms. The same three
numbers (window_*) hold one step drawn from the window, which the
reference takes from the program's leaves and Adam's state before it.

What the check reads is copied to host memory as soon as the program has
made it (host_state, host_outputs), so the check never reads a device
buffer that the program may since have written again.
"""
from __future__ import annotations

import statistics
from types import SimpleNamespace

import torch

from portbench.reference import camera as rcam
from portbench.reference import frame as rf
from portbench.reference.gbuffer import GBuffer

Tensor = torch.Tensor
GBUFFER_FIELDS = ("normal", "linear_z", "velocity", "fwidth_normal", "fwidth_z", "world_pos")
SVGF_FIELDS = ("reprojected", "reprojected_var", "variance_illum", "variance_var", "atrous",
               "atrous_var", "history_tap", "history_tap_var", "modulated", "taa", "moments",
               "history_len")


def host(t: Tensor) -> Tensor:
    """A copy in host memory, which the program cannot overwrite."""
    return t.detach().to("cpu", copy=True)


def host_state(s) -> dict:
    """What the check reads of a program FrameState, copied to the host."""
    return {k: (host(v) if isinstance(v, Tensor) else v)
            for k, v in state_dict(s).items()}


def host_outputs(o) -> SimpleNamespace:
    """What the check reads of a program FrameOutputs, copied to the host."""
    return SimpleNamespace(
        pt_color=host(o.pt_color), accum_color=host(o.accum_color), final=host(o.final),
        gbuffer=GBuffer(*(host(getattr(o.gbuffer, f)) for f in GBuffer._fields)),
        svgf=SimpleNamespace(**{k: host(getattr(o.svgf, k)) for k in SVGF_FIELDS}))


def record_on(rec: dict, device) -> dict:
    """A kept frame's record (check.host_state, host_outputs and the
    camera's arrays) with its tensors on `device`."""
    def on(x):
        return x.to(device) if isinstance(x, Tensor) else x

    o = rec["out"]
    out = SimpleNamespace(
        pt_color=on(o.pt_color), accum_color=on(o.accum_color), final=on(o.final),
        gbuffer=GBuffer(*(on(t) for t in o.gbuffer)),
        svgf=SimpleNamespace(**{k: on(v) for k, v in vars(o.svgf).items()}))
    return dict(rec, state={k: on(v) for k, v in rec["state"].items()},
                next={k: on(v) for k, v in rec["next"].items()},
                camera=rcam.on(rec["camera"], device), out=out)


def bad(p: Tensor, r: Tensor, rtol: float, atol: float) -> Tensor:
    """(H, W) bool: some value of the pixel outside the tolerance (NaN
    counts as outside)."""
    p, r = p.float(), r.float()
    ok = (p - r).abs() <= atol + rtol * r.abs()
    ok = ok if ok.dim() == 2 else ok.all(-1)
    return ~ok


def share(pairs, rtol: float, atol: float) -> float:
    """The share of pixels bad in any of the (program, reference) pairs."""
    acc = None
    for p, r in pairs:
        b = bad(p, r, rtol, atol)
        acc = b if acc is None else acc | b
    return float(acc.float().mean())


def state_dict(s) -> dict:
    """A program FrameState (or a dict) as the reference's state dict."""
    if isinstance(s, dict):
        return s
    return {k: getattr(s, k) for k in rf.STATE_FIELDS + ("frame_idx",)}


def frame_numbers(ref_scene, ref_cfg, sample: dict, rtol: float, atol: float,
                  initial: bool = False) -> dict:
    """One frame: sample = {"state": state before, "camera": the reference's
    camera tensors, "out": the program's FrameOutputs, "next": the state
    the program carries on}."""
    s, cam, o, s2 = (state_dict(sample["state"]), sample["camera"], sample["out"],
                     state_dict(sample["next"]))
    g = GBuffer(*(getattr(o.gbuffer, f) for f in GBuffer._fields))
    sv = o.svgf
    tr = rf.trace_stage(ref_scene, cam, s, ref_cfg)
    rg = tr["gbuffer"]
    rv = rf.reproject_stage(o.pt_color, tr["emission"], tr["albedo"], g, s, ref_cfg)
    at = rf.atrous_stage(sv.variance_illum, sv.variance_var, g, ref_cfg)
    mod = rf.modulate_stage(sv.atrous, tr["albedo"], tr["emission"], g)
    ta = rf.taa_stage(sv.modulated, g, s)
    nums = dict(
        gbuffer=share([(getattr(g, f), getattr(rg, f)) for f in GBUFFER_FIELDS], rtol, atol),
        radiance=share([(o.pt_color, tr["pt_color"]), (o.accum_color, tr["pt_color"])],
                       rtol, atol),
        reproject=share([(sv.reprojected, rv["reprojected"]),
                         (sv.reprojected_var, rv["reprojected_var"]),
                         (sv.moments, rv["moments"]), (sv.history_len, rv["history_len"]),
                         (sv.variance_illum, rv["variance_illum"]),
                         (sv.variance_var, rv["variance_var"])], rtol, atol),
        atrous=share([(sv.atrous, at["atrous"]), (sv.atrous_var, at["atrous_var"]),
                      (sv.history_tap, at["history_tap"]),
                      (sv.history_tap_var, at["history_tap_var"])], rtol, atol),
        modulate=share([(sv.modulated, mod)], rtol, atol),
        taa=share([(sv.taa, ta), (o.final, ta)], rtol, atol))
    want = dict(illum_hist=at["history_tap"], variance_hist=at["history_tap_var"],
                prev_normal=g.normal, prev_linear_z=g.linear_z, moments=rv["moments"],
                history_len=rv["history_len"], accum_color=o.pt_color, taa_color=ta)
    pairs = [(s2[k], v) for k, v in want.items()]
    if initial:
        start = rf.initial_state(ref_cfg.height, ref_cfg.width, cam["eye"].device)
        pairs += [(s[k], start[k]) for k in want]
    st = share(pairs, rtol, atol)
    carried = (s2["frame_idx"] == s["frame_idx"] + 1
               and torch.equal(s2["prev_view_proj"].cpu(), cam["view_proj"].cpu()))
    nums["state"] = st if carried else 1.0
    return nums


def orbit_numbers(ref_scene, ref_cfg, samples: list[dict], rtol: float, atol: float,
                  device) -> dict:
    """The largest of each number over the frames checked, each record
    moved to `device` in its turn; the first sample is the run's frame 0,
    from the initial state."""
    worst: dict = {}
    for i, smp in enumerate(samples):
        for k, v in frame_numbers(ref_scene, ref_cfg, record_on(smp, device), rtol, atol,
                                  initial=(i == 0)).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def _norm(x) -> float:
    return 0.0 if x is None else float(torch.linalg.vector_norm(x.double()))


def _gap(p: float, r: float, floor: float) -> float:
    den = max(r, floor)
    return 0.0 if den == 0.0 else abs(p - r) / den


def train_detail(prog: dict, ref: dict, p0: dict) -> dict:
    """Every reading a train check can compare: each step's loss gap, each
    leaf's first-gradient gap and change gap (leaves whose reference
    gradient is nought to rounding left out of the change), and the
    change gap of the leaf whose reference change is the median."""
    loss = [abs(a - b) / (abs(b) or 1.0) for a, b in zip(prog["loss"], ref["loss"])]
    g_ref = {k: _norm(v) for k, v in ref["grad"].items()}
    g_med = statistics.median(g_ref.values())
    grad = {k: _gap(_norm(prog["grad"].get(k)), g_ref[k], g_med) for k in g_ref}
    # leaves whose reference gradient is nought to rounding move under Adam
    # by round-off alone: left out of the change
    moved = [k for k in g_ref if g_ref[k] > 1e-3 * g_med]
    d_ref = {k: _norm(ref["params"][k] - p0[k]) for k in moved}
    d_med = statistics.median(d_ref.values()) if d_ref else 0.0
    change = {k: _gap(_norm(prog["params"][k] - p0[k]), d_ref[k], d_med) for k in moved}
    by_ref = sorted(moved, key=lambda k: d_ref[k])
    median_leaf = by_ref[(len(by_ref) - 1) // 2] if by_ref else None
    return dict(loss=loss, grad=grad, change=change, median_leaf=median_leaf,
                median_change=change[median_leaf] if median_leaf else 0.0)


def train_numbers(prog: dict, ref: dict, p0: dict) -> dict:
    """prog and ref: {"loss": [per step], "grad": {leaf: first gradient or
    None}, "params": {leaf: after the steps}}; p0: the leaves before.

    The loss of the first step and the change of the median leaf: Adam's
    early steps move every element by about lr whatever its gradient's
    size, so an element of a small leaf (the lights') whose gradient
    rounds to the other sign moves the later losses and that leaf's change
    on some seeds alone (PERF.md section 2); the first gradient by the
    worst leaf."""
    d = train_detail(prog, ref, p0)
    return dict(loss=d["loss"][0], grad=max(d["grad"].values()), change=d["median_change"])


def window_program(rec: dict, b1: float, device) -> tuple[dict, dict, dict]:
    """A train step kept from the window (clients.Train.timed) -> (the
    program's readings as train_numbers takes them, the leaves before the
    step, Adam's state before it {leaf: (exp_avg, exp_avg_sq, step) or
    None}), on `device`. The step's gradient is worked out from Adam's
    first moment before and after it (exp_avg += (1 - b1) (g - exp_avg)),
    in float64."""
    before, after = rec["before"], rec["after"]
    grad = {}
    for k, st in after["adam"].items():
        if st is None:
            grad[k] = None
            continue
        m1 = st[0].double()
        m0 = before["adam"][k][0].double() if before["adam"][k] else torch.zeros_like(m1)
        grad[k] = (m0 + (m1 - m0) / (1.0 - b1)).to(device)
    prog = dict(loss=[rec["loss"]], grad=grad,
                params={k: v.to(device) for k, v in after["params"].items()})
    adam = {k: (None if st is None else (st[0].to(device), st[1].to(device), st[2]))
            for k, st in before["adam"].items()}
    return prog, {k: v.to(device) for k, v in before["params"].items()}, adam


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every number at or under its limit, {name: {value, limit}})."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(numbers[k] <= limits[k] for k in limits), shown
