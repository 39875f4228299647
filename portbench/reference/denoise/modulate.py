# The benchmark's reference: a frozen copy of tpuray_torch/denoise/modulate.py (its
# imports pointed here). The program may change; this copy does not.
"""SVGF modulate (counterpart of tpuray/denoise/modulate.py): re-multiply
the filtered illumination by albedo and re-add first-hit emission
(shaders/svgf_modulate.frag:18-29); sky passes through."""
from __future__ import annotations

import torch


def modulate(illum, albedo, emission, linear_z):
    sky = (linear_z == 1.0)[..., None]
    return torch.where(sky, illum, illum * albedo + emission)
