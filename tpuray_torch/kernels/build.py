"""Build and load the CUDA kernels (csrc/*.cu) at first use.

nvcc compiles the sources of this checkout into a shared library with a
plain C interface, under build/tpuray_torch/<hash>/ at the repository root
(git-ignored), keyed by a hash of the sources and flags; ctypes loads it.
No PyTorch headers are involved, so a build takes seconds.

Flags: sm_90a only; -fmad=false and no fast math, so the kernels' float
results equal the plain PyTorch versions' op for op (see csrc/trace.cu).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "trace.cu",)
BUILD_ROOT = _PKG.parent / "build" / "tpuray_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "tpuray_trace_packets": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                             _I, _I, _I, _P],
    "tpuray_trace_multi": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lib: ctypes.CDLL | None = None
# what the last build printed (ptxas register / spill report) and took
build_log: str = ""
build_seconds: float = 0.0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libtpuray_kernels.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; return its path."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - start
    build_log = proc.stdout + proc.stderr
    (out.parent / "build.log").write_text(" ".join(cmd) + "\n" + build_log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
