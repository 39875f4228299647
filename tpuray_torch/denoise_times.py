"""Device times of the denoiser kernels K4, K5 and TAA on recorded frame
inputs, to compare two versions of the kernels in one call.

    python3 tpuray_torch/denoise_times.py [--tree DIR]

--tree DIR imports tpuray_torch from DIR, a checkout of another commit
(for example the parent, unpacked with `git archive` into the git-ignored
build/), so the same inputs go through that version's kernels; the script
calls only Renderer, reproject_variance_fused, K5's chain (kernels/
atrous.py:chain over atrous_step, or atrous_chain in a tree that predates
the row window) and taa. The inputs: the denoiser's inputs of the 5th
moving frame of the test scene (20,482 triangles) under the default view,
at 800x800 and at 1920x1080, recorded as chip_smoke.py's phase 3 records
them. Times: K4 (one call; also under reproject_gather="tiled" and
fast_reproject=True where the tree has those reads), TAA on that frame's
own inputs (the plain taa, and kernels/taa.py where the tree has it), and
K5's chain on K4's output at 1 to 5
iterations, so that each step's increment shows; each the mean device time
of 20 calls between two CUDA events, after 3 warm-ups, behind a spin kernel
that keeps the host's launch overhead out (this checkout's
traversal_times.kernel_ms, for either tree). Prints one line per time, the K4 inputs'
shares of sky and fallback pixels and of 32 x 8 blocks with a fallback
pixel, then one JSON line {name: ms}. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

SIZES = ((800, 800), (1920, 1080))


class RecordK4:
    """Records the inputs of the next K4 call the denoiser makes."""

    def __init__(self):
        self.inputs = None

    def __enter__(self):
        from tpuray_torch.kernels import reproject as kr
        self.kr, self.real = kr, kr.reproject_variance_fused

        def recording(cfg, **inputs):  # the inputs, and row_window where given
            self.inputs = {k: v.clone() for k, v in inputs.items() if k != "row_window"}
            return self.real(cfg, **inputs)

        kr.reproject_variance_fused = recording
        return self

    def __exit__(self, *exc):
        self.kr.reproject_variance_fused = self.real


def moving_renderer(scene, cfg, frames: int, tracer=None, **cam_kw):
    """A Renderer (through the kernels unless given another tracer) stepped
    through `frames` moving frames -> (renderer, camera, last frame's
    outputs, the state it started from, its K4 inputs)."""
    from tpuray_torch.integrator import path_tracer as pt
    from tpuray_torch.render.renderer import Renderer
    from tpuray_torch.scene.camera import OrbitCamera
    r = Renderer(scene, cfg, tracer=pt.KERNELS if tracer is None else tracer)
    cam = OrbitCamera(width=cfg.width, height=cfg.height, **cam_kw)
    for _ in range(frames - 1):
        r.step(cam.snapshot())
        cam.rotate(0.5, 0.0)
    state = r.state
    with RecordK4() as rec:
        out = r.step(cam.snapshot())
    return r, cam, out, state, rec.inputs


def fallback_shares(k4_in: dict, history_len) -> dict:
    """Shares of sky pixels, of pixels that take the variance fallback
    (history_len < 4, not sky) and of 32 x 8 blocks holding one."""
    import torch
    sky = k4_in["linear_z"] == 1.0
    needs = (history_len < 4) & ~sky
    h, w = needs.shape
    pad = torch.nn.functional.pad(needs.float()[None, None], (0, -w % 32, 0, -h % 8))
    blocks = torch.nn.functional.max_pool2d(pad, (8, 32))
    return dict(sky=float(sky.float().mean()), fallback=float(needs.float().mean()),
                fallback_blocks=float(blocks.mean()))


def _kernel_ms():
    """traversal_times.kernel_ms of this checkout, whatever --tree imports,
    so that two trees are timed alike."""
    spec = importlib.util.spec_from_file_location(
        "_traversal_times", Path(__file__).with_name("traversal_times.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel_ms


def chain_times(chain_in: tuple, cfg) -> list[float]:
    """K5's chain on chain_in (illum, variance, normal, linear_z, fwidth_z)
    at 1 to cfg.num_atrous_iterations iterations: device ms of each."""
    from tpuray_torch.kernels import atrous as ka
    kernel_ms = _kernel_ms()
    if hasattr(ka, "chain"):
        def k5(*args):
            return ka.chain(ka.atrous_step, *args)
    else:  # a tree that predates the row window
        k5 = ka.atrous_chain
    return [kernel_ms(lambda n=n: k5(
        *chain_in, dataclasses.replace(cfg, num_atrous_iterations=n)))
        for n in range(1, cfg.num_atrous_iterations + 1)]


def step_increments(chain_ms: list[float]) -> str:
    """'step 1 +a, step 2 +b, ...': what each step adds to the chain."""
    return ", ".join(f"step {1 << n} +{b - a:.4f}"
                     for n, (a, b) in enumerate(zip([0.0] + chain_ms, chain_ms)))


def taa_times(timed, out, state, size: str) -> None:
    """TAA on a frame's own inputs (its modulated image, the TAA history
    before it, its velocity and depth): the plain taa, and the kernel
    where the tree has it (kernels/taa.py), each through timed."""
    from tpuray_torch.denoise.taa import taa
    args = (out.svgf.modulated, state.taa_color, out.gbuffer.velocity,
            out.gbuffer.linear_z, state.frame_idx)
    # one call a reading: its ~550 launches overflow the launch queue
    timed(f"TAA plain {size}", lambda: taa(*args), 1)
    try:
        from tpuray_torch.kernels import taa as ktaa
    except ImportError:  # a tree that predates the kernel
        return
    timed(f"TAA {size}", lambda: ktaa.taa(*args))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("denoise_times needs a CUDA device")
    import tpuray_torch
    from tpuray_torch.kernels import build
    from tpuray_torch.kernels import reproject as kr
    from tpuray_torch.scene.config import RenderConfig
    from tpuray_torch.scene.procedural import make_test_scene
    kernel_ms = _kernel_ms()

    print(f"tree {Path(tpuray_torch.__file__).parents[1]}; device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    build.load()
    dev = torch.device("cuda")
    scene = make_test_scene(subdiv=5, env_width=512, device=dev)
    times = {}

    def timed(name, fn, reps=20):
        times[name] = kernel_ms(fn, reps)
        print(f"{name}: {times[name]:.4f} ms", flush=True)

    for w, h in SIZES:
        cfg = RenderConfig(width=w, height=h, compact_frac=0.0, compact_auto=False)
        _, _, out, state, k4_in = moving_renderer(scene, cfg, 5)
        k4 = kr.reproject_variance_fused(cfg, **k4_in)
        print(f"{w}x{h} K4 inputs (frame 5): {fallback_shares(k4_in, k4.history_len)}",
              flush=True)
        timed(f"K4 {w}x{h}", lambda: kr.reproject_variance_fused(cfg, **k4_in))
        for read, kw in (("tiled", dict(reproject_gather="tiled")),
                         ("fast", dict(fast_reproject=True))):
            rcfg = dataclasses.replace(cfg, **kw)
            try:
                kr.reproject_variance_fused(rcfg, **k4_in)
            except NotImplementedError:  # a tree that predates the read
                continue
            timed(f"K4 {read} {w}x{h}", lambda: kr.reproject_variance_fused(rcfg, **k4_in))
        taa_times(timed, out, state, f"{w}x{h}")
        chain_in = (k4.var_illum, k4.var_variance, k4_in["normal"], k4_in["linear_z"],
                    k4_in["fwidth_z"])
        chain_ms = chain_times(chain_in, cfg)
        for n, ms in enumerate(chain_ms, 1):
            times[f"K5 {w}x{h} chain of {n}"] = ms
            print(f"K5 {w}x{h} chain of {n}: {ms:.4f} ms", flush=True)
        print(f"K5 {w}x{h} per step (ms): {step_increments(chain_ms)}", flush=True)
        del k4_in, k4, chain_in, out, state
    print(json.dumps(times), flush=True)


if __name__ == "__main__":
    main()
