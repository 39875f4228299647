"""Roofline arithmetic: the H100's published peaks and the least work of
K4 and K5, copied from chip_smoke.py (HBM_BYTES_PER_S, FP32_OPS_PER_S,
K4_*_OPS, K5_PIXEL_OPS, bound()).

A kernel's least time is the larger of its bytes over the HBM rate and
its float operations over the float32 rate. Bytes count each input read
once and each output written once; operations count what this frame's
pixels need (non-sky pixels; K4's rescue and fallback where they ran).
"""
from __future__ import annotations

# H100 SXM, NVIDIA's data sheet, 700 W: HBM bytes/s and float32 op/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

K4_PIXEL_OPS = 190      # reproject pass: demodulate, uv, 4 taps x 30, EMA tail
K4_RESCUE_OPS = 580     # + 16 rescue taps x 36, where the reprojection failed
K4_FALLBACK_OPS = 2156  # + 7x7 fallback, 49 taps x 44, where history < 4
# K4 reads 14 images (color, emission, albedo 3 each, motion 2, normal 3,
# linear_z, fwidth_normal, fwidth_z 1 each, prev_illum 3, prev_variance 1,
# prev_normal 3, prev_linear_z 1, prev_moments 2, prev_history_len 1) and
# writes 6 (rep_illum 3, rep_variance 1, moments 2, history_len 1,
# var_illum 3, var_variance 1): 39 floats a non-sky pixel. A sky pixel
# passes through (csrc/reproject.cu): it reads linear_z, normal, color,
# the prior moments and history length (10 floats) and writes the 11
# outputs: 21 floats
K4_PIXEL_FLOATS = 28 + 11
K4_SKY_FLOATS = 10 + 11
# one a-trous iteration of a non-sky pixel: 24 taps x 35 + 41 (chip_smoke.py)
K5_PIXEL_OPS = 24 * 35 + 41
# the chain reads var_illum 3, var_variance 1, normal 3, linear_z 1,
# fwidth_z 1 and writes the output and the history tap, 4 each
K5_PIXEL_FLOATS = 9 + 8


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations")."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def k4_bound(pixels: int, non_sky: int, failed: int, fallback: int) -> tuple[float, str]:
    """K4 on one frame: `failed` non-sky pixels whose reprojection failed
    (history length 1), `fallback` non-sky pixels under history 4."""
    return bound((non_sky * K4_PIXEL_FLOATS + (pixels - non_sky) * K4_SKY_FLOATS) * 4,
                 non_sky * K4_PIXEL_OPS + failed * K4_RESCUE_OPS + fallback * K4_FALLBACK_OPS)


def k5_bound(pixels: int, non_sky: int, iterations: int) -> tuple[float, str]:
    """K5's chain of `iterations` on one frame."""
    return bound(pixels * K5_PIXEL_FLOATS * 4, non_sky * iterations * K5_PIXEL_OPS)
