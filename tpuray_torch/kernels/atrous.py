"""K5: the SVGF a-trous chain (atrous_chain), one kernel launch per iteration.

Counterpart of tpuray/kernels/atrous_pallas.py. The CUDA kernel lives in
csrc/atrous.cu (see its header for the design: each block stages a
shared-memory tile of its 32 pixels in x by 8 lattice rows of the step and
their halo); its plain version is
denoise/atrous.py:atrous_iteration, chained here as atrous_chain_plain.

The wrapper
- raises if an input requires grad (forward only, as K4);
- runs the plain chain when its tensors lie on the CPU;
- on CUDA tensors, checks device, dtype, shape and contiguity and launches
  one iteration per step 1 << i on the current stream, each reading the
  last (H, W, 3) illum + (H, W) variance and writing a new pair in the same
  layout (no packing), raises if a launch failed, and adds one to
  LAUNCHES["k5"] per iteration. The output of iteration
  cfg.history_atrous_tap is a pair of its own: it is next frame's history,
  not a copy. There is no fallback.
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


def atrous_chain_plain(illum: Tensor, variance: Tensor, normal: Tensor,
                       linear_z: Tensor, fwidth_z: Tensor, cfg: RenderConfig
                       ) -> tuple[Pair, Pair]:
    """K5's chain in plain PyTorch. Returns ((illum, variance), (tap_illum,
    tap_variance)); a tap index at or beyond the last iteration returns the
    chain's input."""
    tap = (illum, variance)
    for i in range(cfg.num_atrous_iterations):
        illum, variance = atrous_iteration(illum, variance, normal, linear_z,
                                           fwidth_z, step=1 << i, cfg=cfg)
        if i == cfg.history_atrous_tap:
            tap = (illum, variance)
    return (illum, variance), tap


def run_chain(step, illum: Tensor, variance: Tensor, cfg: RenderConfig
              ) -> tuple[Pair, Pair]:
    """cfg.num_atrous_iterations calls of step(illum, variance, 1 << i) ->
    (illum, variance), each on the last one's output, scheduled as
    atrous_chain_plain schedules its iterations. Returns (the last output,
    the output of iteration cfg.history_atrous_tap); a tap index at or
    beyond the last iteration gives the chain's input."""
    cur = tap = (illum, variance)
    for i in range(cfg.num_atrous_iterations):
        cur = step(*cur, 1 << i)
        if i == cfg.history_atrous_tap:
            tap = cur
    return cur, tap


def atrous_chain(illum: Tensor, variance: Tensor, normal: Tensor,
                 linear_z: Tensor, fwidth_z: Tensor, cfg: RenderConfig
                 ) -> tuple[Pair, Pair]:
    """All cfg.num_atrous_iterations iterations (step 1 << i).

    illum (H, W, 3), variance (H, W), normal (H, W, 3), linear_z (H, W),
    fwidth_z (H, W), float32. Returns ((illum, variance), (tap_illum,
    tap_variance)), the tap being the output of iteration
    cfg.history_atrous_tap (main.cpp:521-525), as run_chain gives them."""
    build.refuse_grad("atrous_chain (K5)", NO_GRAD_HINT, illum, variance,
                      normal, linear_z, fwidth_z)
    if illum.device.type == "cpu":
        return atrous_chain_plain(illum, variance, normal, linear_z, fwidth_z, cfg)
    if illum.device.type != "cuda":
        raise ValueError(f"atrous_chain: unsupported device {illum.device}")
    dev = illum.device
    h, w = illum.shape[:2]
    for x, name, c in ((illum, "illum", 3), (variance, "variance", 1),
                       (normal, "normal", 3), (linear_z, "linear_z", 1),
                       (fwidth_z, "fwidth_z", 1)):
        build.check(x, name, torch.float32, (h, w) if c == 1 else (h, w, c), dev)
    n_sq = squarings(cfg.sigma_n)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(il: Tensor, var: Tensor, step: int) -> Pair:
        out = (torch.empty_like(il), torch.empty_like(var))
        with torch.cuda.device(dev):
            rc = lib.tpuray_atrous_step(
                il.data_ptr(), var.data_ptr(), normal.data_ptr(), linear_z.data_ptr(),
                fwidth_z.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), h, w, step,
                ctypes.c_float(cfg.sigma_n), -1 if n_sq is None else n_sq,
                ctypes.c_float(cfg.sigma_l), int(cfg.reference_quirks), stream)
        build.raise_on(rc, "atrous_chain (K5)")
        LAUNCHES["k5"] += 1
        return out

    return run_chain(launch, illum, variance, cfg)
