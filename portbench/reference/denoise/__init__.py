"""Frozen copies of tpuray_torch/denoise's plain stages."""
