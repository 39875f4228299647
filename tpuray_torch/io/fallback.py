"""Numpy readers and writers for OBJ, Radiance RGBE and BMP files.

Copies of tpuray/io/fallback.py:parse_obj_py, read_hdr_py, write_hdr_py,
read_bmp_py and write_bmp_py (the JAX package's numpy fallbacks for its
g++ library; the port has only these). The BVH builder and the env-map
cache of the same file are copied once, in scene/host.py.
tests/test_torch_io.py holds each equal to its original, bit for bit.
"""
from __future__ import annotations

import re

import numpy as np


def parse_obj_py(path: str):
    """-> (positions (V, 3) f32, texcoords (VT, 2) f32, face vertex ids
    (F, 3) int32, face texcoord ids (F, 3) int32, -1 where absent), from
    the first three corners of each face."""
    positions, texcoords, face_v, face_vt = [], [], [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v" and len(parts) >= 4:
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "vt" and len(parts) >= 3:
                texcoords.append([float(parts[1]), float(parts[2])])
            elif parts[0] == "f" and len(parts) >= 4:
                vi, ti = [], []
                for tok in parts[1:4]:
                    sub = tok.split("/")
                    vi.append(int(sub[0]) - 1)
                    if len(sub) >= 2 and sub[1]:
                        ti.append(int(sub[1]) - 1)
                    else:
                        ti.append(-1)
                face_v.append(vi)
                face_vt.append(ti)
    pos = np.asarray(positions, np.float32).reshape(-1, 3)
    uv = np.asarray(texcoords, np.float32).reshape(-1, 2)
    fv = np.asarray(face_v, np.int32).reshape(-1, 3)
    fvt = np.asarray(face_vt, np.int32).reshape(-1, 3)
    return pos, uv, fv, fvt


def read_hdr_py(path: str) -> np.ndarray:
    """Radiance RGBE (flat or new-style RLE scanlines) -> (H, W, 3) f32."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"#?"):
        raise IOError("not a radiance file")
    pos = data.index(b"\n") + 1
    while True:  # the header ends at an empty line
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line.strip() == b"":
            break
    eol = data.index(b"\n", pos)
    m = re.match(rb"-Y (\d+) \+X (\d+)", data[pos:eol])
    if not m:
        raise IOError("unsupported resolution line")
    h, w = int(m.group(1)), int(m.group(2))
    pos = eol + 1
    out = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        head = data[pos:pos + 4]
        if len(head) < 4:
            raise IOError("truncated")
        if head[0] == 2 and head[1] == 2 and ((head[2] << 8) | head[3]) == w and w >= 8:
            pos += 4
            scan = np.zeros((w, 4), np.uint8)
            for c in range(4):
                x = 0
                while x < w:
                    code = data[pos]
                    pos += 1
                    if code > 128:
                        n = code - 128
                        scan[x:x + n, c] = data[pos]
                        pos += 1
                        x += n
                    else:
                        n = code
                        scan[x:x + n, c] = np.frombuffer(data[pos:pos + n], np.uint8)
                        pos += n
                        x += n
            out[y] = scan
        else:
            x = 0
            shift = 0
            while x < w:
                px = np.frombuffer(data[pos:pos + 4], np.uint8)
                pos += 4
                if px[0] == 1 and px[1] == 1 and px[2] == 1:
                    n = int(px[3]) << shift
                    out[y, x:x + n] = out[y, x - 1]
                    x += n
                    shift += 8
                else:
                    out[y, x] = px
                    x += 1
                    shift = 0
    rgb = out[..., :3].astype(np.float32)
    exp = out[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(np.float32(1.0), exp - 136)).astype(np.float32)
    return rgb * scale[..., None]


def write_hdr_py(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) float -> a flat (uncompressed) Radiance RGBE file."""
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    m = rgb.max(axis=-1)
    mant, exp = np.frexp(m)
    scale = np.where(m >= 1e-32, mant * 256.0 / np.maximum(m, 1e-38), 0.0)
    e = np.zeros((h, w, 4), np.uint8)
    e[..., :3] = np.minimum(255.0, rgb * scale[..., None]).astype(np.uint8)
    e[..., 3] = np.where(m >= 1e-32, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(e.tobytes())


def read_bmp_py(path: str) -> np.ndarray:
    """Uncompressed 24- or 32-bit BMP -> (H, W, 4) uint8 RGBA, top row first."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise IOError("not a BMP")
    data_off = int.from_bytes(data[10:14], "little")
    w = int.from_bytes(data[18:22], "little", signed=True)
    h = int.from_bytes(data[22:26], "little", signed=True)
    bpp = int.from_bytes(data[28:30], "little")
    comp = int.from_bytes(data[30:34], "little")
    if bpp not in (24, 32) or comp != 0:
        raise IOError("unsupported BMP")
    topdown = h < 0
    h = abs(h)
    bypp = bpp // 8
    stride = (w * bypp + 3) & ~3
    rows = np.frombuffer(data[data_off:data_off + stride * h], np.uint8)
    rows = rows.reshape(h, stride)[:, : w * bypp].reshape(h, w, bypp)
    if not topdown:
        rows = rows[::-1]
    rgba = np.zeros((h, w, 4), np.uint8)
    rgba[..., 0] = rows[..., 2]
    rgba[..., 1] = rows[..., 1]
    rgba[..., 2] = rows[..., 0]
    rgba[..., 3] = rows[..., 3] if bypp == 4 else 255
    return rgba


def write_bmp_py(path: str, rgb: np.ndarray) -> None:
    """Write an uncompressed 24-bit bottom-up BMP (floats in [0, 1] are
    scaled by 255)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    h, w = rgb.shape[:2]
    stride = (w * 3 + 3) & ~3
    img = np.zeros((h, stride), np.uint8)
    bgr = rgb[::-1][..., ::-1]  # bottom-up, BGR
    img[:, : w * 3] = bgr.reshape(h, w * 3)
    data_size = stride * h
    header = bytearray(54)
    header[0:2] = b"BM"
    header[2:6] = (54 + data_size).to_bytes(4, "little")
    header[10:14] = (54).to_bytes(4, "little")
    header[14:18] = (40).to_bytes(4, "little")
    header[18:22] = w.to_bytes(4, "little")
    header[22:26] = h.to_bytes(4, "little")
    header[26:28] = (1).to_bytes(2, "little")
    header[28:30] = (24).to_bytes(2, "little")
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(img.tobytes())
