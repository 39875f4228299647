"""K5: one SVGF a-trous iteration a kernel launch (atrous_step), with the
row window of a sharded frame's rank.

Counterpart of tpuray/kernels/atrous_pallas.py. The CUDA kernel lives in
csrc/atrous.cu (see its header for the design: each block stages a
shared-memory tile of its 32 pixels in x by 8 lattice rows of the step and
their halo); its plain version is denoise/atrous.py:atrous_iteration.
atrous_step takes row_window=(row0, global_h) as atrous_iteration does: a
row shard of a frame split across ranks exchanges a halo before each
iteration (dist/frame.py), so the frames run the chain one iteration at a
time (denoise/svgf.py:svgf_pipeline); `chain` runs it alone.

atrous_step
- raises if an input requires grad (forward only, as K4);
- runs the plain version when its tensors lie on the CPU;
- on CUDA tensors, checks device, dtype, shape and contiguity, launches
  one iteration on the current stream, reading (H, W, 3) illum + (H, W)
  variance and writing a new pair in the same layout (no packing), raises
  if the launch failed, and adds one to LAUNCHES["k5"]. There is no
  fallback.
"""
from __future__ import annotations

import ctypes

import torch

from tpuray_torch.denoise.atrous import atrous_iteration
from tpuray_torch.denoise.common import squarings
from tpuray_torch.kernels import build
from tpuray_torch.kernels.reproject import NO_GRAD_HINT
from tpuray_torch.scene.config import RenderConfig

Tensor = torch.Tensor

# kernel launches since the last reset (the plain path never counts)
LAUNCHES = {"k5": 0}

Pair = tuple[Tensor, Tensor]


def reset_launches() -> None:
    LAUNCHES["k5"] = 0


def chain(iteration, illum: Tensor, variance: Tensor, normal: Tensor,
          linear_z: Tensor, fwidth_z: Tensor, cfg: RenderConfig) -> tuple[Pair, Pair]:
    """The single-device a-trous chain, for the checks and timings that
    take K5 on its own (the frames run it inside denoise/svgf.py:
    svgf_pipeline): cfg.num_atrous_iterations calls of iteration(illum,
    variance, normal, linear_z, fwidth_z, 1 << i, cfg), each on the last
    one's output, iteration being atrous_step (K5, one launch each) or
    denoise/atrous.py:atrous_iteration (its plain version). Returns
    ((illum, variance), (tap_illum, tap_variance)), the tap being the
    output of iteration cfg.history_atrous_tap (main.cpp:521-525); a tap at
    or beyond the last iteration gives the chain's input."""
    cur = tap = (illum, variance)
    for i in range(cfg.num_atrous_iterations):
        cur = iteration(*cur, normal, linear_z, fwidth_z, 1 << i, cfg)
        if i == cfg.history_atrous_tap:
            tap = cur
    return cur, tap


def atrous_step(illum: Tensor, variance: Tensor, normal: Tensor, linear_z: Tensor,
                fwidth_z: Tensor, step: int, cfg: RenderConfig,
                row_window: tuple[int, int] | None = None) -> Pair:
    """One iteration at dilation `step` -> (illum, variance), one launch.

    illum (H, W, 3), variance (H, W), normal (H, W, 3), linear_z (H, W),
    fwidth_z (H, W), float32; row_window as denoise/atrous.py:
    atrous_iteration's (its plain version)."""
    build.refuse_grad("atrous_step (K5)", NO_GRAD_HINT, illum, variance,
                      normal, linear_z, fwidth_z)
    if illum.device.type == "cpu":
        return atrous_iteration(illum, variance, normal, linear_z, fwidth_z, step, cfg,
                                row_window=row_window)
    if illum.device.type != "cuda":
        raise ValueError(f"atrous_step: unsupported device {illum.device}")
    dev = illum.device
    h, w = illum.shape[:2]
    for x, name, c in ((illum, "illum", 3), (variance, "variance", 1),
                       (normal, "normal", 3), (linear_z, "linear_z", 1),
                       (fwidth_z, "fwidth_z", 1)):
        build.check(x, name, torch.float32, (h, w) if c == 1 else (h, w, c), dev)
    row0, global_h = row_window if row_window is not None else (0, h)
    n_sq = squarings(cfg.sigma_n)
    out = (torch.empty_like(illum), torch.empty_like(variance))
    with torch.cuda.device(dev):
        rc = build.load().tpuray_atrous_step(
            illum.data_ptr(), variance.data_ptr(), normal.data_ptr(), linear_z.data_ptr(),
            fwidth_z.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), h, w, row0,
            global_h, step, ctypes.c_float(cfg.sigma_n), -1 if n_sq is None else n_sq,
            ctypes.c_float(cfg.sigma_l), int(cfg.reference_quirks),
            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(rc, "atrous_step (K5)")
    LAUNCHES["k5"] += 1
    return out
