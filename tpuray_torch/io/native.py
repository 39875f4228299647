"""ctypes bindings to the native host library (counterpart of
tpuray/io/native.py): OBJ, Radiance RGBE and BMP readers, the SAH BVH
builder and the env-map sampling cache in C++ (csrc/tpuray_native.cpp, the
JAX package's tpuray/native/tpuray_native.cpp but for one comment line).

The shared object is built at first use with g++ into
build/tpuray_torch/native/<hash>/ at the repository root (git-ignored),
keyed by a hash of the source and the flags: to a temporary name under a
file lock, then renamed into place, so processes that start together (test
workers, ranks) build it once and never load half a file. Every entry
returns None (write_hdr_native False) when the library cannot be built or
loaded, and its caller then takes the numpy version in io/fallback.py and
scene/host.py, as the JAX package does; available() says which path runs.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "tpuray_native.cpp"
BUILD_ROOT = _PKG.parent / "build" / "tpuray_torch" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_S = ctypes.c_char_p
# name -> (restype, argtypes)
_SIGNATURES = {
    "tr_obj_parse": (_P, [_S]),
    "tr_obj_counts": (_I, [_P, _IP, _IP, _IP]),
    "tr_obj_fill": (_I, [_P, _FP, _FP, _IP, _IP]),
    "tr_obj_free": (None, [_P]),
    "tr_hdr_read": (_P, [_S]),
    "tr_hdr_counts": (_I, [_P, _IP, _IP]),
    "tr_hdr_fill": (_I, [_P, _FP]),
    "tr_hdr_free": (None, [_P]),
    "tr_hdr_write": (_I, [_S, _I, _I, _FP]),
    "tr_bmp_read": (_P, [_S]),
    "tr_bmp_counts": (_I, [_P, _IP, _IP]),
    "tr_bmp_fill": (_I, [_P, _U8P]),
    "tr_bmp_free": (None, [_P]),
    "tr_bvh_build": (_P, [_FP, _I, _I]),
    "tr_bvh_counts": (_I, [_P, _IP, _IP]),
    "tr_bvh_fill": (_I, [_P, _FP, _FP, _IP, _IP, _IP, _IP]),
    "tr_bvh_free": (None, [_P]),
    "tr_env_cache": (_I, [_FP, _I, _I, _FP]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False
# what the last build in this process printed and took (0.0: none ran)
build_log: str = ""
build_seconds: float = 0.0


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libtpuray_native.so"


def build() -> Path:
    """Compile the library unless this exact build exists; return its path.
    Raises RuntimeError when g++ is missing or fails."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host library cannot be built")
    with open(out.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        build_seconds = time.perf_counter() - start
        build_log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed:\n{build_log}")
        os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL | None:
    """The native library, built on first use; None if it cannot be built
    or loaded (then every entry returns None)."""
    global _lib, _failed, build_log
    with _lock:
        if _lib is None and not _failed:
            try:
                lib = ctypes.CDLL(str(build()))
            except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
                build_log = str(e)  # a failed g++ run's message holds its output
                _failed = True
                return None
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library loads (else the numpy versions run)."""
    return get_lib() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_FP)


def _ip(a: np.ndarray):
    return a.ctypes.data_as(_IP)


def parse_obj_native(path: str):
    """-> (positions (nv, 3) f32, texcoords (nt, 2) f32, face_v (nf, 3) i32,
    face_vt (nf, 3) i32 with -1 = no uv), or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.tr_obj_parse(str(path).encode())
    if not h:
        raise FileNotFoundError(f"cannot parse obj: {path}")
    try:
        nv, nt, nf = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        lib.tr_obj_counts(h, ctypes.byref(nv), ctypes.byref(nt), ctypes.byref(nf))
        pos = np.empty((nv.value, 3), np.float32)
        uv = np.empty((max(nt.value, 1), 2), np.float32)
        fv = np.empty((nf.value, 3), np.int32)
        fvt = np.empty((nf.value, 3), np.int32)
        lib.tr_obj_fill(h, _fp(pos), _fp(uv), _ip(fv), _ip(fvt))
        return pos, uv[: nt.value], fv, fvt
    finally:
        lib.tr_obj_free(h)


def read_hdr_native(path: str):
    """-> (h, w, 3) float32 linear RGB, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.tr_hdr_read(str(path).encode())
    if not h:
        raise IOError(f"cannot read hdr: {path}")
    try:
        w, ht = ctypes.c_int(), ctypes.c_int()
        lib.tr_hdr_counts(h, ctypes.byref(w), ctypes.byref(ht))
        rgb = np.empty((ht.value, w.value, 3), np.float32)
        lib.tr_hdr_fill(h, _fp(rgb))
        return rgb
    finally:
        lib.tr_hdr_free(h)


def write_hdr_native(path: str, rgb: np.ndarray) -> bool:
    """Write (h, w, 3) RGB as RGBE; False without the library or on a
    write error."""
    lib = get_lib()
    if lib is None:
        return False
    rgb = np.ascontiguousarray(rgb, np.float32)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"rgb must be (h, w, 3), got {rgb.shape}")
    return lib.tr_hdr_write(str(path).encode(), rgb.shape[1], rgb.shape[0], _fp(rgb)) == 0


def read_bmp_native(path: str):
    """-> (h, w, 4) uint8 RGBA, top row first, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.tr_bmp_read(str(path).encode())
    if not h:
        raise IOError(f"cannot read bmp: {path}")
    try:
        w, ht = ctypes.c_int(), ctypes.c_int()
        lib.tr_bmp_counts(h, ctypes.byref(w), ctypes.byref(ht))
        rgba = np.empty((ht.value, w.value, 4), np.uint8)
        lib.tr_bmp_fill(h, rgba.ctypes.data_as(_U8P))
        return rgba
    finally:
        lib.tr_bmp_free(h)


def build_bvh_native(tri_verts: np.ndarray, leaf_size: int = 8):
    """tri_verts: (T, 3, 3) or (T, 9) float32 vertex positions ->
    dict(aabb_min, aabb_max, first_tri, tri_count, skip, perm), or None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(np.asarray(tri_verts, np.float32).reshape(-1, 9))
    t = v.shape[0]
    h = lib.tr_bvh_build(_fp(v), t, int(leaf_size))
    if not h:
        raise RuntimeError("bvh build failed")
    try:
        n_nodes, n_tris = ctypes.c_int(), ctypes.c_int()
        lib.tr_bvh_counts(h, ctypes.byref(n_nodes), ctypes.byref(n_tris))
        n = n_nodes.value
        amin = np.empty((n, 3), np.float32)
        amax = np.empty((n, 3), np.float32)
        first = np.empty((n,), np.int32)
        count = np.empty((n,), np.int32)
        skip = np.empty((n,), np.int32)
        perm = np.empty((t,), np.int32)
        lib.tr_bvh_fill(h, _fp(amin), _fp(amax), _ip(first), _ip(count), _ip(skip),
                        _ip(perm))
        return dict(aabb_min=amin, aabb_max=amax, first_tri=first,
                    tri_count=count, skip=skip, perm=perm)
    finally:
        lib.tr_bvh_free(h)


def env_cache_native(rgb: np.ndarray):
    """-> (h, w, 3) float32 cache (sample_x, sample_y, pdf), or None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, np.float32)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"rgb must be (h, w, 3), got {rgb.shape}")
    ht, w = rgb.shape[:2]
    cache = np.empty((ht, w, 3), np.float32)
    if lib.tr_env_cache(_fp(rgb), w, ht, _fp(cache)) != 0:
        raise ValueError("env cache build failed (zero-luminance envmap?)")
    return cache
