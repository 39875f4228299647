"""K5: the SVGF a-trous chain (atrous_chain), one kernel launch per iteration.

Counterpart of tpuray/kernels/atrous_pallas.py. The CUDA kernel lives in
csrc/atrous.cu (see its header for the design); its plain version is
denoise/atrous.py:atrous_iteration, chained here as atrous_chain_plain.

The wrapper
- raises if an input requires grad (forward only, as K4);
- runs the plain chain when its tensors lie on the CPU;
- on CUDA tensors, checks device, dtype, shape and contiguity, packs the
  static G-buffer once per chain (float4 normal + linear_z, and fwidth_z)
  and the state as float4 (illum, variance), launches one iteration per
  step 1 << i on the current stream, ping-ponging two buffers, raises if a
  launch failed, and adds one to LAUNCHES["k5"] per iteration. The output
  of iteration cfg.history_atrous_tap gets a buffer of its own: it is next
  frame's history, not a copy. There is no fallback.
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


def _unpack(d: Tensor) -> Pair:
    return d[..., :3].contiguous(), d[..., 3].contiguous()


def atrous_chain(illum: Tensor, variance: Tensor, normal: Tensor,
                 linear_z: Tensor, fwidth_z: Tensor, cfg: RenderConfig
                 ) -> tuple[Pair, Pair]:
    """All cfg.num_atrous_iterations iterations (step 1 << i).

    illum (H, W, 3), variance (H, W), normal (H, W, 3), linear_z (H, W),
    fwidth_z (H, W), float32. Returns ((illum, variance), (tap_illum,
    tap_variance)), the tap being the output of iteration
    cfg.history_atrous_tap (main.cpp:521-525)."""
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
    n_iters = cfg.num_atrous_iterations
    if n_iters == 0:
        return (illum, variance), (illum, variance)
    dyn = torch.cat([illum, variance[..., None]], dim=-1)
    stat = torch.cat([normal, linear_z[..., None]], dim=-1)
    n_sq = squarings(cfg.sigma_n)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    spare = [torch.empty_like(dyn), torch.empty_like(dyn)]
    cur, tap = dyn, dyn
    for i in range(n_iters):
        if i == cfg.history_atrous_tap:
            out = tap = torch.empty_like(dyn)
        else:
            out = spare[0] if spare[0] is not cur else spare[1]
        with torch.cuda.device(dev):
            rc = lib.tpuray_atrous_step(
                cur.data_ptr(), stat.data_ptr(), fwidth_z.data_ptr(),
                out.data_ptr(), h, w, 1 << i, ctypes.c_float(cfg.sigma_n),
                -1 if n_sq is None else n_sq, ctypes.c_float(cfg.sigma_l),
                int(cfg.reference_quirks), stream)
        build.raise_on(rc, "atrous_chain (K5)")
        LAUNCHES["k5"] += 1
        cur = out
    if tap is dyn:
        return _unpack(cur), (illum, variance)
    return _unpack(cur), _unpack(tap)
