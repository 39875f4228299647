"""Explicit temporal state of the render loop (counterpart of
tpuray/render/frame_state.py): a dataclass of tensors.

frame_idx is a host integer: it keys the RNG streams and the Sobol point,
which the port computes without reading the device.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class FrameState:
    illum_hist: Tensor      # (H, W, 3) SVGF illumination history
    variance_hist: Tensor   # (H, W)
    prev_normal: Tensor     # (H, W, 3)
    prev_linear_z: Tensor   # (H, W) (1.0 = sky)
    moments: Tensor         # (H, W, 2)
    history_len: Tensor     # (H, W)
    accum_color: Tensor     # (H, W, 3)
    taa_color: Tensor       # (H, W, 3)
    frame_idx: int
    prev_view_proj: Tensor  # (4, 4)

    @staticmethod
    def initial(height: int, width: int, device="cpu",
                view_proj=None) -> "FrameState":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        vp = (torch.as_tensor(view_proj, dtype=torch.float32, device=device)
              if view_proj is not None
              else torch.eye(4, dtype=torch.float32, device=device))
        return FrameState(
            illum_hist=z(height, width, 3), variance_hist=z(height, width),
            prev_normal=z(height, width, 3),
            prev_linear_z=torch.ones((height, width), dtype=torch.float32,
                                     device=device),
            moments=z(height, width, 2), history_len=z(height, width),
            accum_color=z(height, width, 3), taa_color=z(height, width, 3),
            frame_idx=0, prev_view_proj=vp)

    def replace(self, **kw) -> "FrameState":
        return dataclasses.replace(self, **kw)

    def reset_accumulation(self) -> "FrameState":
        return self.replace(frame_idx=0)
