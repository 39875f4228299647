"""Radiance RGBE (.hdr) read and write (counterpart of tpuray/io/hdr.py):
read_hdr(path) -> (H, W, 3) float32, write_hdr(path, rgb), the numpy
versions of io/fallback.py."""
from tpuray_torch.io.fallback import read_hdr_py as read_hdr  # noqa: F401
from tpuray_torch.io.fallback import write_hdr_py as write_hdr  # noqa: F401
