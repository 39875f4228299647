"""Radiance RGBE (.hdr) read and write (counterpart of tpuray/io/hdr.py):
the native library when it loads, else the numpy versions of
io/fallback.py."""
from __future__ import annotations

import numpy as np

from tpuray_torch.io import native
from tpuray_torch.io.fallback import read_hdr_py, write_hdr_py


def read_hdr(path: str) -> np.ndarray:
    """-> (H, W, 3) float32 linear RGB."""
    out = native.read_hdr_native(path)
    if out is None:
        out = read_hdr_py(path)
    return out


def write_hdr(path: str, rgb: np.ndarray) -> None:
    if not native.write_hdr_native(path, np.asarray(rgb, np.float32)):
        write_hdr_py(path, rgb)
