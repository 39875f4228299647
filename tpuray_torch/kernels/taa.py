"""TAA as one CUDA kernel launch (taa).

No TPU kernel stands behind it: tpuray computes TAA with XLA ops
(tpuray/denoise/taa.py). The CUDA kernel lives in csrc/taa.cu (see its
header for the design: 32 x 8 pixels a block, the tile and a 1-pixel halo
staged in shared memory already tonemapped and in YCoCg-R, the 4 history
taps read directly). It was added because the plain version,
denoise/taa.py:taa, issues ~550 PyTorch ops a call, the largest block of a
frame's host issue. Its bound is bytes: 48 a pixel (the current colour,
the history, velocity and depth read once, one colour written), 0.009 ms
at 800x800 and 0.030 ms at 1920x1080 on 3.35 TB/s.

It computes the plain taa under the exact history read, bit for bit on
the card: whole image, row window (row0, global_h) and static camera. The
tile-windowed read (taa(tiled_fetch=True)) has no kernel:
denoise/svgf.py:svgf_pipeline runs the plain taa there.

taa
- raises if an input requires grad (forward only, as K4 and K5;
  pallas_denoise=False runs the plain taa, which differentiates);
- runs the plain taa when its tensors lie on the CPU (which opens the
  tpuray.taa span itself);
- on CUDA tensors, inside the tpuray.taa span, checks device, dtype, shape
  and contiguity, allocates the one (H, W, 3) output, launches the kernel
  on the current stream, raises if the launch failed, and adds one to
  LAUNCHES["taa"]. There is no fallback.
"""
from __future__ import annotations

import torch

from tpuray_torch.denoise import taa as plain
from tpuray_torch.kernels import build
from tpuray_torch.kernels.reproject import NO_GRAD_HINT
from tpuray_torch.utils.metrics import span

Tensor = torch.Tensor

# kernel launches since the last reset (the plain path never counts)
LAUNCHES = {"taa": 0}


def reset_launches() -> None:
    LAUNCHES["taa"] = 0


def taa(cur_color: Tensor, prev_color: Tensor, velocity: Tensor, linear_z: Tensor,
        frame: int, static_camera: bool = False,
        row_window: tuple[int, int] | None = None) -> Tensor:
    """denoise/taa.py:taa under the exact history read, one launch.

    cur_color, prev_color (H, W, 3), velocity (H, W, 2), linear_z (H, W),
    float32; frame: the frame index (0 passes the current colour through);
    row_window as the plain taa's."""
    build.refuse_grad("taa (the TAA kernel)", NO_GRAD_HINT, cur_color, prev_color,
                      velocity, linear_z)
    if cur_color.device.type == "cpu":
        return plain.taa(cur_color, prev_color, velocity, linear_z, frame,
                         static_camera=static_camera, row_window=row_window)
    if cur_color.device.type != "cuda":
        raise ValueError(f"taa: unsupported device {cur_color.device}")
    with span("tpuray.taa"):
        dev = cur_color.device
        h, w = linear_z.shape[:2]
        for x, name, c in ((cur_color, "cur_color", 3), (prev_color, "prev_color", 3),
                           (velocity, "velocity", 2), (linear_z, "linear_z", 1)):
            build.check(x, name, torch.float32, (h, w) if c == 1 else (h, w, c), dev)
        row0, global_h = row_window if row_window is not None else (0, h)
        if h < 1 or w < 1 or global_h < 1:
            raise ValueError(f"taa needs an image of at least 1x1, got {h}x{w} "
                             f"of {global_h} rows")
        out = torch.empty_like(cur_color)
        with torch.cuda.device(dev):
            rc = build.load().tpuray_taa(
                cur_color.data_ptr(), prev_color.data_ptr(), velocity.data_ptr(),
                linear_z.data_ptr(), out.data_ptr(), h, w, row0, global_h,
                int(frame == 0), int(static_camera),
                torch.cuda.current_stream(dev).cuda_stream)
        build.raise_on(rc, "taa (the TAA kernel)")
        LAUNCHES["taa"] += 1
        return out
