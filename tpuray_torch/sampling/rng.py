"""Counter-free GPU-style RNG (counterpart of tpuray/sampling/rng.py).

The JAX package hashes in wrapping uint32. PyTorch's uint32 arithmetic is
partial, so the per-pixel streams here run in int64 with `& 0xFFFFFFFF`
after every multiply and add: values stay below 2^32, products below
2^62, and the bits equal the uint32 ones exactly. The Sobol point depends
only on (frame, bounce) and is computed on the host in numpy.

A frame's keys (FrameKeys: pixel_seed's frame term and the Sobol point of
each bounce) are host values on every path but one: Renderer.step on the
card stages them into a device block before it replays the path tracer's
CUDA graphs (integrator/path_graphs.py), and the functions here take
either form with the same bits (an int64 term, float32 points).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

M32 = 0xFFFFFFFF
_INV_U32 = float(np.float32(1.0 / 4294967296.0))  # rand() = hash / 2^32


def u32(x: Tensor) -> Tensor:
    """Integer tensor -> int64 holding its uint32 bit pattern."""
    return x.to(torch.int64) & M32


def seed_term(frame: int) -> int:
    """pixel_seed's frame term, frame*26699 in wrapping uint32."""
    return (int(frame) & M32) * 26699 & M32


def pixel_seed(px: Tensor, py: Tensor, frame: int) -> Tensor:
    """Initial Wang-hash stream state: (px*1973 + py*9277 + frame*26699) | 1."""
    return keyed_seed(px, py, seed_term(frame))


def keyed_seed(px: Tensor, py: Tensor, term: int | Tensor) -> Tensor:
    """pixel_seed with its frame term given: a host int, or an int64 device
    scalar holding the same value (a staged frame's)."""
    s = (u32(px) * 1973 + u32(py) * 9277 + term) & M32
    return s | 1


def wang_hash(seed: Tensor) -> tuple[Tensor, Tensor]:
    """One Wang-hash step. Returns (bits, next_seed), both int64 in [0, 2^32)."""
    seed = (seed ^ 61) ^ (seed >> 16)
    seed = (seed * 9) & M32
    seed = seed ^ (seed >> 4)
    seed = (seed * 0x27D4EB2D) & M32
    seed = seed ^ (seed >> 15)
    return seed, seed


def rand(seed: Tensor) -> tuple[Tensor, Tensor]:
    """Uniform [0,1) f32 from the stream; returns (u, next_seed)."""
    bits, seed = wang_hash(seed)
    return bits.to(torch.float32) * _INV_U32, seed


# Sobol direction numbers, dims 0..7 (Joe-Kuo D(6) table, regenerated from
# the recurrences): (s, a, m_i) per dimension; dim 0 is van der Corput.
_JOE_KUO = [
    None,
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
    (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]),
    (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]),
]


def _sobol_matrices(n_dims: int = 8, n_bits: int = 32) -> np.ndarray:
    """Direction numbers V[d, j] as uint32, MSB-aligned."""
    V = np.zeros((n_dims, n_bits), dtype=np.uint64)
    for j in range(n_bits):
        V[0, j] = np.uint64(1) << np.uint64(31 - j)
    for d in range(1, n_dims):
        s, a, m = _JOE_KUO[d]
        v = np.zeros(n_bits, dtype=np.uint64)
        for j in range(s):
            v[j] = np.uint64(m[j]) << np.uint64(31 - j)
        for j in range(s, n_bits):
            v[j] = v[j - s] ^ (v[j - s] >> np.uint64(s))
            for k in range(1, s):
                if (a >> (s - 1 - k)) & 1:
                    v[j] ^= v[j - k]
        V[d] = v
    return V.astype(np.uint32)


SOBOL_V = _sobol_matrices()  # (8, 32) uint32


def gray_code(i):
    i = np.asarray(i, np.uint32)
    return i ^ (i >> np.uint32(1))


def sobol(dim: int, index) -> np.ndarray:
    """Sobol sample of dimension `dim` at integer index (numpy, any shape):
    the XOR of the direction numbers of the set bits, as f32."""
    index = np.asarray(index, np.uint32)
    result = np.zeros_like(index)
    for j in range(32):
        bit = (index >> np.uint32(j)) & np.uint32(1)
        result = result ^ np.where(bit == 1, SOBOL_V[dim, j], np.uint32(0))
    return result.astype(np.float32) * np.float32(1.0 / 0xFFFFFFFF)


def sobol_vec2(frame: int, bounce: int) -> np.ndarray:
    """The per-(frame, bounce) 2D Sobol point shared by every pixel."""
    idx = gray_code(int(frame) & M32)
    return np.stack([sobol(2 * bounce, idx), sobol(2 * bounce + 1, idx)])


def sobol_points(frame: int, depth: int) -> np.ndarray:
    """(depth, 2) float32: the Sobol point of each bounce of frame `frame`
    (sobol_vec2(frame + 1, bounce), the path tracer's draw), every
    dimension at once."""
    idx = gray_code((int(frame) + 1) & M32)
    bits = (idx >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    v = np.bitwise_xor.reduce(
        np.where(bits == 1, SOBOL_V[:2 * depth], np.uint32(0)), axis=1)
    return (v.astype(np.float32) * np.float32(1.0 / 0xFFFFFFFF)).reshape(depth, 2)


class FrameKeys(NamedTuple):
    """What a frame's sample streams take from its index: pixel_seed's term
    (int, or an int64 device scalar) and the Sobol point of each bounce
    ((depth, 2) float32, numpy or a device tensor)."""

    seed_term: int | Tensor
    sobol: np.ndarray | Tensor


def frame_keys(frame: int, depth: int) -> FrameKeys:
    """A frame's keys as host values."""
    return FrameKeys(seed_term(frame), sobol_points(frame, depth))


def cranley_patterson_offsets(px: Tensor, py: Tensor) -> tuple[Tensor, Tensor]:
    """Per-pixel CPR offsets: a 2-draw Wang stream seeded by
    (px*1973 + py*9277 + 59*26699) | 1."""
    s = ((u32(px) * 1973 + u32(py) * 9277 + 59 * 26699) & M32) | 1
    u, s = rand(s)
    v, _ = rand(s)
    return u, v


def cranley_patterson_rotate(p: np.ndarray | Tensor, off_u: Tensor, off_v: Tensor
                             ) -> tuple[Tensor, Tensor]:
    """Rotate a 2D point by per-pixel offsets, wrapping to [0, 1). p: a
    float32 pair on the host, or on the device (a staged frame's): either
    way a float32 add of the same value."""
    x = off_u + p[0]
    y = off_v + p[1]
    x = torch.where(x > 1.0, x - 1.0, x)
    x = torch.where(x < 0.0, x + 1.0, x)
    y = torch.where(y > 1.0, y - 1.0, y)
    y = torch.where(y < 0.0, y + 1.0, y)
    return x, y
