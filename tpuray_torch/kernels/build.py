"""Build and load the CUDA kernels (csrc/*.cu) at first use.

nvcc compiles the sources of this checkout, one process per source, all
started together, and links them into one shared library with a plain C
interface, under build/tpuray_torch/<hash>/ at the repository root
(git-ignored), keyed by a hash of the sources and flags; ctypes loads it.
No PyTorch headers are involved, so a build takes seconds.

Flags: sm_90a only; -fmad=false and no fast math, so the kernels' float
results equal the plain PyTorch versions' op for op (see
csrc/trace_common.cuh).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(_PKG / "csrc" / f for f in ("trace.cu", "trace_wide.cu",
                                             "trace_chunked.cu", "reproject.cu",
                                             "atrous.cu", "gather.cu", "taa.cu"))
HEADERS = tuple(_PKG / "csrc" / f for f in ("trace_common.cuh", "denoise_common.cuh"))
BUILD_ROOT = _PKG.parent / "build" / "tpuray_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "tpuray_trace_packets": [_P, _P, _P, _I, _P, _P, _P, _F, _P, _P, _I, _I, _P],
    "tpuray_trace_batched": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P],
    "tpuray_trace_chunked": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                             _P],
    "tpuray_trace_multi": [_P, _P, _P, _I, _P] + [_P] * 12 + [_I, _I, _I, _P],
    "tpuray_reproject_variance": [_P] * 20 + [_I, _I, _I, _I, _F, _F, _F, _F, _F,
                                              _I, _F, _I, _I, _P, _P] + [_I] * 5 + [_P],
    "tpuray_atrous_step": [_P] * 7 + [_I, _I, _I, _I, _I, _F, _I, _F, _I, _P],
    "tpuray_onehot_gather": [_P, _P, _P, _I, _I, _I, _P],
    "tpuray_taa": [_P] * 5 + [_I] * 6 + [_P],
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
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libtpuray_kernels.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; return its path."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    start = time.perf_counter()
    objs = [str(out.parent / f"{src.stem}.{tag}.o") for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            for obj, src in zip(objs, SOURCES)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_name(f".{out.name}.{tag}")
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *objs]
    failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(link)
    build_seconds = time.perf_counter() - start
    build_log = "".join(" ".join(c) + "\n" + log
                        for c, log in zip(cmds + [link], logs))
    (out.parent / "build.log").write_text(build_log)
    for o in objs:
        Path(o).unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({' '.join(failed[0])}):\n{build_log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def check(x, name: str, dtype, shape: tuple, device) -> None:
    """Raise unless tensor x is what a kernel takes: on `device`, of `dtype`
    and `shape`, contiguous."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def refuse_grad(what: str, hint: str, *tensors) -> None:
    """Raise if autograd would record a gradient through a forward-only
    kernel (any input requires grad while grad mode is on): the kernel would
    hand back a tensor with no graph, and the gradient would be lost
    silently. The JAX package's Pallas kernels have no JVP rule either."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is forward-only: an input requires grad, and the JAX "
            f"package's Pallas kernel has no JVP rule either; {hint}")


def raise_on(rc: int, what: str) -> None:
    """Raise if a launch returned a cudaError_t other than cudaSuccess."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {rc}")


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
