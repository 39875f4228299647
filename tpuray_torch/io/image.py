"""Image decode and encode: BMP, PNG, TGA, Radiance HDR (and JPEG through
PIL where it is installed) in; BMP and PNG out. Counterpart of
tpuray/io/image.py: read_bmp takes the native library when it loads, else
numpy; read_png always takes the stdlib decoder, which the JAX package
keeps as its fallback behind PIL.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from tpuray_torch.io import native
from tpuray_torch.io.fallback import read_bmp_py
from tpuray_torch.io.fallback import write_bmp_py as write_bmp  # noqa: F401


def read_bmp(path: str) -> np.ndarray:
    """-> (H, W, 4) uint8 RGBA, top row first: native, else numpy."""
    out = native.read_bmp_native(path)
    if out is None:
        out = read_bmp_py(path)
    return out


def encode_png(img: np.ndarray, compress_level: int = 6) -> bytes:
    """img: (H, W, 3) float in [0, 1] or uint8 -> PNG bytes (filter 0)."""
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, compress_level))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """8-bit gray, gray + alpha, RGB or RGBA PNG, filters 0-4, not
    interlaced -> (H, W, 3) float32 in [0, 1]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise IOError(f"{path}: not a PNG")
    pos, w = 8, 0
    idat = b""
    h = color_type = 0
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", payload[:10])
            if bit_depth != 8:
                raise IOError(f"{path}: unsupported bit depth {bit_depth}")
            if payload[12] != 0:
                raise IOError(f"{path}: interlaced PNG unsupported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + ln
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * nch
    img = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = np.frombuffer(
            raw, np.uint8, stride, y * (stride + 1) + 1).astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:          # Up
            cur = (line + prev) & 0xFF
        else:                     # Sub, Average and Paeth scan left to right
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - nch] if x >= nch else 0
                b = prev[x]
                c = prev[x - nch] if x >= nch else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:             # Paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        img[y] = cur.astype(np.uint8)
        prev = cur
    img = img.reshape(h, w, nch)
    if nch == 1:
        img = np.repeat(img, 3, axis=-1)
    elif nch == 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    elif nch == 4:
        img = img[..., :3]
    return img.astype(np.float32) / 255.0


def write_png(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3) float in [0, 1] or uint8."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def read_tga(path: str) -> np.ndarray:
    """Truevision TGA (types 2 and 3 uncompressed, 10 and 11 RLE; 8, 24 or
    32 bits a pixel) -> (H, W, 3) float32 in [0, 1]."""
    with open(path, "rb") as f:
        data = f.read()
    id_len = data[0]
    cmap_type = data[1]
    img_type = data[2]
    if cmap_type != 0:
        raise IOError(f"{path}: color-mapped TGA unsupported")
    if img_type not in (2, 3, 10, 11):
        raise IOError(f"{path}: TGA type {img_type} unsupported")
    w = int.from_bytes(data[12:14], "little")
    h = int.from_bytes(data[14:16], "little")
    bpp = data[16]
    descriptor = data[17]
    if bpp not in (8, 24, 32):
        raise IOError(f"{path}: TGA {bpp}bpp unsupported")
    nch = bpp // 8
    pos = 18 + id_len + int.from_bytes(data[3:5], "little")  # + colormap length

    if img_type in (2, 3):  # uncompressed
        px = np.frombuffer(data, np.uint8, w * h * nch, pos).reshape(h, w, nch)
    else:  # RLE
        out = np.empty(w * h * nch, np.uint8)
        written = 0
        total = w * h * nch
        while written < total:
            hdr = data[pos]
            pos += 1
            count = (hdr & 0x7F) + 1
            if hdr & 0x80:  # run packet: one pixel repeated
                pix = np.frombuffer(data, np.uint8, nch, pos)
                pos += nch
                out[written:written + count * nch] = np.tile(pix, count)
            else:  # raw packet
                n = count * nch
                out[written:written + n] = np.frombuffer(data, np.uint8, n, pos)
                pos += n
            written += count * nch
        px = out.reshape(h, w, nch)

    if nch == 1:
        rgb = np.repeat(px, 3, axis=-1)
    else:
        rgb = px[..., 2::-1]  # BGR(A) -> RGB
    if not (descriptor & 0x20):  # the origin is bottom-left unless bit 5 is set
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb).astype(np.float32) / 255.0


def read_image(path: str) -> np.ndarray:
    """Decode a texture image -> (H, W, 3) float32 in [0, 1] (HDR images
    keep their range). Dispatch by magic bytes, TGA by extension."""
    with open(path, "rb") as f:
        magic = f.read(11)
    if magic[:8] == b"\x89PNG\r\n\x1a\n":
        return read_png(path)
    if magic[:2] == b"BM":
        return read_bmp(path)[..., :3].astype(np.float32) / 255.0
    if magic[:2] == b"\xff\xd8":  # JPEG SOI
        try:
            from PIL import Image
        except ImportError as e:
            raise NotImplementedError(
                f"JPEG decode for {path} needs PIL (absent); convert it to PNG "
                "first") from e
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"), np.uint8)
        return arr.astype(np.float32) / 255.0
    if magic[:10] == b"#?RADIANCE" or magic[:6] == b"#?RGBE":
        from tpuray_torch.io.hdr import read_hdr
        return read_hdr(path)
    ext = str(path).rsplit(".", 1)[-1].lower()
    if ext == "tga":  # TGA has no magic
        return read_tga(path)
    raise NotImplementedError(
        f"unsupported image format for {path} (magic {magic[:4]!r}); "
        "supported: PNG, BMP, TGA, JPEG (with PIL), Radiance HDR")
