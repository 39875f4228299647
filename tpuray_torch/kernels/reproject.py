"""K4: SVGF reprojection + spatial variance fallback (reproject_variance_fused).

Counterpart of tpuray/kernels/reproject_pallas.py. The CUDA kernel lives
in csrc/reproject.cu (see its header for the design: one launch; a block
whose pixels need the variance fallback reprojects a halo of 3 into a
shared-memory tile and filters from it). It computes what the JAX
package's exact path computes, reproject(reproject_gather="exact")
followed by estimate_variance, which is this module's plain version; the
TPU kernel's tile-windowed history read is not carried over.

row_window=(row0, global_h): the inputs are a row shard of a taller image
extended by its neighbours' rows (dist/frame.py); both the kernel and its
plain version take the window as the plain stages do (reproject's in_shard,
the global bounds masks), on the same extended rows.

The wrapper
- raises if an input requires grad (forward only, as the JAX package's
  kernel; pallas_denoise=False runs the plain stages, which differentiate);
- runs the plain version when its tensors lie on the CPU;
- on CUDA tensors, checks device, dtype, shape and contiguity, allocates
  the six outputs, launches the kernel on the current stream, raises if
  the launch failed, and adds one to LAUNCHES["k4"]. There is no fallback.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpuray_torch.denoise.common import squarings
from tpuray_torch.denoise.reproject import gather_mode, reproject
from tpuray_torch.denoise.variance import estimate_variance
from tpuray_torch.kernels import build
from tpuray_torch.scene.config import RenderConfig

Tensor = torch.Tensor

# kernel launches since the last reset (the plain path never counts)
LAUNCHES = {"k4": 0}

NO_GRAD_HINT = ("RenderConfig(pallas_denoise=False) runs the plain denoiser "
                "stages, which carry the gradient")


def reset_launches() -> None:
    LAUNCHES["k4"] = 0


class FusedOutput(NamedTuple):
    rep_illum: Tensor     # (H, W, 3) reprojected illumination (pre-fallback)
    rep_variance: Tensor  # (H, W)
    var_illum: Tensor     # (H, W, 3) after the spatial variance fallback
    var_variance: Tensor  # (H, W)
    moments: Tensor       # (H, W, 2)
    history_len: Tensor   # (H, W)


# (name, channels) of the inputs, in the C function's order
_INPUTS = (("color", 3), ("emission", 3), ("albedo", 3), ("motion", 2),
           ("normal", 3), ("linear_z", 1), ("fwidth_normal", 1),
           ("fwidth_z", 1), ("prev_illum", 3), ("prev_variance", 1),
           ("prev_normal", 3), ("prev_linear_z", 1), ("prev_moments", 2),
           ("prev_history_len", 1))
# their names: reproject's positional order
INPUT_NAMES = tuple(n for n, _ in _INPUTS)


def reproject_variance_plain(cfg: RenderConfig, static_camera: bool = False,
                             row_window: tuple[int, int] | None = None,
                             **inputs: Tensor) -> FusedOutput:
    """K4's function in plain PyTorch: the exact reproject, then
    estimate_variance, both with row_window on the same rows.
    static_camera takes the static specialisation (motion ignored), which
    has no kernel."""
    rep = reproject(**inputs, cfg=cfg, static_camera=static_camera, row_window=row_window)
    var = estimate_variance(
        illum=rep.illum, variance=rep.variance, moments=rep.moments,
        history_len=rep.history_len, normal=inputs["normal"],
        linear_z=inputs["linear_z"], fwidth_z=inputs["fwidth_z"], cfg=cfg,
        row_window=row_window)
    return FusedOutput(rep_illum=rep.illum, rep_variance=rep.variance,
                       var_illum=var.illum, var_variance=var.variance,
                       moments=rep.moments, history_len=rep.history_len)


def reproject_variance_fused(cfg: RenderConfig,
                             row_window: tuple[int, int] | None = None,
                             **inputs: Tensor) -> FusedOutput:
    """Moving-camera reproject + spatial-variance fallback.

    Keyword inputs as reproject's (color, emission, albedo, motion, normal,
    linear_z, fwidth_normal, fwidth_z, prev_illum, prev_variance,
    prev_normal, prev_linear_z, prev_moments, prev_history_len), each
    (H, W) or (H, W, C) float32; row_window as the module says. Returns
    the six FusedOutput fields."""
    gather_mode(cfg)
    if set(inputs) != set(INPUT_NAMES):
        raise TypeError(f"reproject_variance_fused takes {list(INPUT_NAMES)}")
    build.refuse_grad("reproject_variance_fused (K4)", NO_GRAD_HINT,
                      *inputs.values())
    color = inputs["color"]
    if color.device.type == "cpu":
        return reproject_variance_plain(cfg, row_window=row_window, **inputs)
    if color.device.type != "cuda":
        raise ValueError(f"reproject_variance_fused: unsupported device {color.device}")
    dev = color.device
    h, w = color.shape[:2]
    row0, global_h = row_window if row_window is not None else (0, h)
    if h < 2 or w < 2 or global_h < 2:
        raise ValueError(f"K4 needs an image of at least 2x2, got {h}x{w} of {global_h} rows")
    for name, c in _INPUTS:
        build.check(inputs[name], name, torch.float32,
                    (h, w) if c == 1 else (h, w, c), dev)

    def empty(*c):
        return torch.empty((h, w, *c), dtype=torch.float32, device=dev)

    out = FusedOutput(rep_illum=empty(3), rep_variance=empty(),
                      var_illum=empty(3), var_variance=empty(),
                      moments=empty(2), history_len=empty())
    n_sq = squarings(cfg.sigma_n)
    f = ctypes.c_float
    with torch.cuda.device(dev):
        rc = build.load().tpuray_reproject_variance(
            *[inputs[n].data_ptr() for n, _ in _INPUTS],
            out.rep_illum.data_ptr(), out.rep_variance.data_ptr(),
            out.moments.data_ptr(), out.history_len.data_ptr(),
            out.var_illum.data_ptr(), out.var_variance.data_ptr(),
            h, w, row0, global_h, f(cfg.reproj_depth_threshold), f(cfg.reproj_normal_threshold),
            f(cfg.history_cap), f(cfg.alpha_min), f(cfg.sigma_n),
            -1 if n_sq is None else n_sq, f(cfg.sigma_l),
            int(cfg.reference_quirks),
            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(rc, "reproject_variance_fused (K4)")
    LAUNCHES["k4"] += 1
    return out
